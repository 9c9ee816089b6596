"""The port's contrastive losses against the JAX package's.

- Dense ``supcon_loss``: value and input gradient, SimCLR and SupCon,
  contrast_mode 'all' and 'one', tau in {0.07, 0.5}.
- The plain forms of the two CUDA kernels against the Pallas kernels run as
  the JAX package's own tests run them (``interpret=True``), including a
  rectangular call whose anchor rows start at a row offset (the sharded
  form).
- ``fused_supcon_loss`` on CPU tensors against the JAX fused loss.
- The dispatch rule: a tensor that is neither on the CPU nor on CUDA raises
  instead of being served by the plain form, and without ``nvcc`` the
  kernel library cannot be built and the build raises.

Tolerances: values rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6 (the JAX
package pins its fused loss at 2e-6 of dense, ``tests/test_pallas_loss.py``;
the extra room is for two frameworks' summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.ops import pallas_loss
from simclr_pytorch_distributed_tpu.ops.losses import supcon_loss as jax_supcon_loss
from simclr_pytorch_distributed_tpu_torch.ops import fused_loss, native
from simclr_pytorch_distributed_tpu_torch.ops.losses import l2_normalize, supcon_loss
from torch_threads import limit_threads

limit_threads()


def _features(seed, batch, n_views=2, dim=24):
    f = np.random.default_rng(seed).standard_normal((batch, n_views, dim)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _labels(seed, batch, classes=4):
    return np.random.default_rng(seed + 100).integers(0, classes, batch).astype(np.int32)


@pytest.mark.parametrize("method", ["SimCLR", "SupCon"])
@pytest.mark.parametrize("contrast_mode", ["all", "one"])
@pytest.mark.parametrize("temp", [0.07, 0.5])
def test_dense_matches_jax(method, contrast_mode, temp):
    f = _features(0, 12, dim=16)
    lab = _labels(0, 12) if method == "SupCon" else None

    def jax_fn(x):
        return jax_supcon_loss(
            x, labels=None if lab is None else jnp.asarray(lab),
            temperature=temp, contrast_mode=contrast_mode,
        )

    val_j, grad_j = jax.value_and_grad(jax_fn)(jnp.asarray(f))
    x = torch.tensor(f, requires_grad=True)
    val_p = supcon_loss(
        x, None if lab is None else torch.from_numpy(lab),
        temperature=temp, contrast_mode=contrast_mode,
    )
    val_p.backward()
    np.testing.assert_allclose(val_p.item(), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-6)


def _kernel_inputs(seed, n, d, row_lo, row_hi, classes=None):
    f = _features(seed, n, n_views=1, dim=d)[:, 0]
    ids = np.arange(n, dtype=np.int32) % (n // 2) if classes is None else (
        np.random.default_rng(seed).integers(0, classes, n).astype(np.int32)
    )
    gid = np.arange(n, dtype=np.int32)
    rows = slice(row_lo, row_hi)
    return f[rows], f, ids[rows], ids, gid[rows], gid


@pytest.mark.parametrize(
    "n,d,row_lo,row_hi,classes,bm,bn",
    [
        (32, 16, 0, 32, None, 8, 16),   # square, SimCLR ids, 4x2 grid
        (48, 24, 16, 32, None, 8, 16),  # rectangular: rows 16..31 of 48
        (32, 16, 0, 32, 5, 16, 8),      # SupCon labels
    ],
)
def test_plain_kernel_forms_match_pallas(n, d, row_lo, row_hi, classes, bm, bn):
    temp, base = 0.3, 0.07
    frow, fcol, idr, idc, grow, gcol = _kernel_inputs(1, n, d, row_lo, row_hi, classes)
    j_loss, j_lse, j_cnt = pallas_loss._fwd_call(
        *map(jnp.asarray, (frow, fcol, idr, idc, grow, gcol)),
        temp, base, True, bm, bn,
    )
    t_args = tuple(map(torch.from_numpy, (frow, fcol, idr, idc, grow, gcol)))
    p_loss, p_lse, p_cnt = fused_loss.fused_rows(*t_args, temp, base)
    np.testing.assert_allclose(p_loss.numpy(), np.asarray(j_loss)[:, 0], rtol=1e-5)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse)[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(p_cnt.numpy(), np.asarray(j_cnt)[:, 0])

    # column-side statistics for the backward: the forward over all rows
    _, lse_all, cnt_all = fused_loss.fused_rows(
        t_args[1], t_args[1], t_args[3], t_args[3], t_args[5], t_args[5], temp, base
    )
    coeff = (temp / base) / n
    j_df = pallas_loss._bwd_call(
        *map(jnp.asarray, (frow, fcol, idr, idc, grow, gcol)),
        jnp.asarray(p_lse.numpy()), jnp.asarray(lse_all.numpy()),
        jnp.asarray(p_cnt.numpy()), jnp.asarray(cnt_all.numpy()),
        temp, coeff, True, bm, bn,
    )
    p_df = fused_loss.fused_bwd(*t_args, p_lse, lse_all, p_cnt, cnt_all, temp, coeff)
    np.testing.assert_allclose(p_df.numpy(), np.asarray(j_df), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_labels", [False, True])
@pytest.mark.parametrize("temp", [0.07, 0.5])
def test_fused_loss_matches_jax_fused(use_labels, temp):
    f = _features(2, 16, dim=32)
    lab = _labels(2, 16) if use_labels else None

    def jax_fn(x):
        return pallas_loss.fused_supcon_loss(
            x, labels=None if lab is None else jnp.asarray(lab),
            temperature=temp, interpret=True,
        )

    val_j, grad_j = jax.value_and_grad(jax_fn)(jnp.asarray(f))
    x = torch.tensor(f, requires_grad=True)
    val_p = fused_loss.fused_supcon_loss(
        x, None if lab is None else torch.from_numpy(lab), temperature=temp
    )
    val_p.backward()
    np.testing.assert_allclose(val_p.item(), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-6)


def test_fused_takes_any_row_count():
    # 2 x 37 = 74 rows: no divisibility gate, unlike the Pallas wrapper
    f = _features(3, 37, dim=20)
    a = torch.tensor(f, requires_grad=True)
    b = torch.tensor(f, requires_grad=True)
    dense = supcon_loss(a, temperature=0.5)
    fused = fused_loss.fused_supcon_loss(b, temperature=0.5)
    dense.backward()
    fused.backward()
    np.testing.assert_allclose(fused.item(), dense.item(), rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_non_cpu_tensor_is_not_served_by_the_plain_form():
    f = torch.empty(8, 4, device="meta")
    ids = torch.empty(8, dtype=torch.int32, device="meta")
    launches = fused_loss.fwd_launches
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fused_loss.fused_rows(f, f, ids, ids, ids, ids, 0.5, 0.07)
    mixed = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fused_loss.fused_rows(f, f, mixed, mixed, mixed, mixed, 0.5, 0.07)
    assert fused_loss.fwd_launches == launches


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build("fused_supcon_loss")
    assert not list(tmp_path.glob("*.so"))


def test_l2_normalize_guards_zero_rows():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(l2_normalize(x).numpy(), [[0.6, 0.8], [0.0, 0.0]])
