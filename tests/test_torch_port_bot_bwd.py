"""The redesigned Bottleneck backward (``bottleneck_bwd`` on the pipelined
GEMM core of ``csrc/conv_gemm_sm90.cuh``), held on the CPU through models of
its schedule.

- The stride-2 data gradients by parity: the transposed 3x3/s2 as four
  sub-GEMMs, one per parity class (ih mod 2, iw mod 2) of the input grid,
  each over only the taps that reach it, and the transposed 1x1/s2 as the
  even-even class alone. A plain PyTorch model of that decomposition (the
  tap lists of ``transposed3_plan`` / ``pointwise_dx_plan``) equals
  ``fused_conv._conv_dx`` (the Pallas backward's dilate-then-convolve) in
  float64 to 1e-12, and the JAX package's data gradient (``jax.vjp`` of the
  strided conv the Pallas backward transposes) in fp32 at rtol 1e-5 (with
  an absolute floor of 1e-5 x max |dx|, for entries that cancel to zero).
  The four classes take each of the nine taps exactly once.
- The whole schedule: a test-local model that runs the backward in the
  kernel's order (the recomputed forward's operands ``a = rnd(relu(y *
  scale + shift))`` staged in the compute dtype, stage 3 in two passes with
  ``dz`` and the cotangents stored in the compute dtype, the parity split)
  against ``bottleneck_bwd_reference``: in float64 to 1e-12 (the algebra),
  in bf16 within the relative-L2 pin ``chip_smoke.py`` holds the bf16
  kernel to against the bf16 plain form, and with its staged ``a`` and
  ``dz`` bitwise equal to the values the plain forms round at the same
  points. So the redesign moves no rounding point.
- ``supports_bottleneck`` still admits every recipe and ragged geometry.
- ``native.library_path`` hashes the headers a ``.cu`` includes.

Inputs are numpy draws from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
from simclr_pytorch_distributed_tpu_torch.ops import native

EPS = 1e-5

# the rn50 recipe's stride-2 sites (layer2-4 block0: input grid, cin, planes)
# at 4 rows and a sixteenth of their channels, then even ragged grids
STRIDE2_GEOMETRIES = [
    (4, 32, 32, 16, 8),
    (4, 16, 16, 32, 16),
    (4, 8, 8, 64, 32),
    (3, 10, 6, 12, 5),
    (2, 6, 14, 8, 3),
]

# identity, stride-1 projection, stride-2 projection, and the ragged
# shapes chip_smoke.py runs on the card (P = 10 identity, P = 40 at s2)
SCHEDULE_GEOMETRIES = [
    (2, 8, 8, 16, 4, 1),
    (2, 8, 8, 8, 4, 1),
    (2, 8, 8, 16, 8, 2),
    (6, 10, 6, 40, 10, 1),
    (6, 10, 6, 24, 40, 2),
]


def _rand(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float64))


# ---------------------------------------------------------------------------
# The parity decomposition
# ---------------------------------------------------------------------------


def parity_classes(stride):
    """``[(ph, pw, [(kh, kw, dh, dw), ...])]``: the classes of the input grid
    of a 3x3 pad-1 conv's data gradient and the taps of each, as
    ``transposed3_plan`` builds them. Input pixel (2 i + ph, 2 j + pw) takes
    dy[i + dh, j + dw] through tap (kh, kw)."""
    if stride == 1:
        return [(0, 0, [(kh, kw, 1 - kh, 1 - kw) for kh in range(3) for kw in range(3)])]
    classes = []
    for ph in range(2):
        for pw in range(2):
            taps = [(kh, kw, (ph + 1 - kh) // 2, (pw + 1 - kw) // 2)
                    for kh in range(3) if (ph + 1 - kh) % 2 == 0
                    for kw in range(3) if (pw + 1 - kw) % 2 == 0]
            classes.append((ph, pw, taps))
    return classes


def _shift(v, dh, dw):
    """``out[:, i, j] = v[:, i + dh, j + dw]``, zero outside ``v``."""
    n, h, w, c = v.shape
    out = v.new_zeros((n, h, w, c))
    i0, i1 = max(0, -dh), min(h, h - dh)
    j0, j1 = max(0, -dw), min(w, w - dw)
    if i0 < i1 and j0 < j1:
        out[:, i0:i1, j0:j1] = v[:, i0 + dh:i1 + dh, j0 + dw:j1 + dw]
    return out


def dx3_by_parity(dy, k, stride, h, w):
    """The data gradient of the 3x3 pad-1 conv (HWIO ``k``) of stride
    ``stride`` by parity class: each class a GEMM over its own taps with
    the channel-swapped weights, written to its strided pixels."""
    kt = k.permute(0, 1, 3, 2)
    n, ho, wo, _ = dy.shape
    out = dy.new_zeros((n, h, w, k.shape[2]))
    for ph, pw, taps in parity_classes(stride):
        acc = sum(_shift(dy, dh, dw) @ kt[kh, kw] for kh, kw, dh, dw in taps)
        out[:, ph::stride, pw::stride] = acc
    return out


def dx1_by_parity(dy, k, stride, h, w):
    """The data gradient of the 1x1 conv ``[cin, cout]`` of stride
    ``stride``: the even-even class takes ``dy k^T``, the others nothing."""
    out = dy.new_zeros((dy.shape[0], h, w, k.shape[0]))
    out[:, ::stride, ::stride] = dy @ k.T
    return out


def test_parity_classes_take_each_tap_once():
    taps = [(kh, kw) for _, _, ts in parity_classes(2) for kh, kw, _, _ in ts]
    assert sorted(taps) == [(kh, kw) for kh in range(3) for kw in range(3)]
    assert [len(ts) for _, _, ts in parity_classes(2)] == [1, 2, 2, 4]
    assert sorted((kh, kw) for kh, kw, _, _ in parity_classes(1)[0][2]) == sorted(taps)


@pytest.mark.parametrize("kind", ["3x3", "1x1"])
@pytest.mark.parametrize("n,h,w,cin,p", STRIDE2_GEOMETRIES)
def test_parity_model_equals_conv_dx_in_float64(kind, n, h, w, cin, p):
    rng = np.random.default_rng(11)
    ho, wo = h // 2, w // 2
    if kind == "3x3":
        k = _rand(rng, (3, 3, p, p), 0.3)
        dy = _rand(rng, (n, ho, wo, p))
        got, ref = dx3_by_parity(dy, k, 2, h, w), fc._conv_dx(dy, k, 2, h, w)
    else:
        k = _rand(rng, (cin, 4 * p), 0.3)
        dy = _rand(rng, (n, ho, wo, 4 * p))
        got, ref = dx1_by_parity(dy, k, 2, h, w), fc._conv_dx(dy, k, 2, h, w)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-12 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("kind", ["3x3", "1x1"])
@pytest.mark.parametrize("n,h,w,cin,p", [STRIDE2_GEOMETRIES[1], STRIDE2_GEOMETRIES[3]])
def test_parity_model_equals_jax_data_gradient(kind, n, h, w, cin, p):
    rng = np.random.default_rng(12)
    ho, wo = h // 2, w // 2
    if kind == "3x3":
        k = (rng.standard_normal((3, 3, p, p)) * 0.3).astype(np.float32)
        dy = rng.standard_normal((n, ho, wo, p)).astype(np.float32)
        x_shape, k4, pad = (n, h, w, p), k, ((1, 1), (1, 1))
    else:
        k = (rng.standard_normal((cin, 4 * p)) * 0.3).astype(np.float32)
        dy = rng.standard_normal((n, ho, wo, 4 * p)).astype(np.float32)
        x_shape, k4, pad = (n, h, w, cin), k.reshape(1, 1, cin, 4 * p), ((0, 0), (0, 0))

    def conv(x):
        return jax.lax.conv_general_dilated(x, jnp.asarray(k4), (2, 2), pad,
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _, vjp = jax.vjp(conv, jnp.zeros(x_shape, jnp.float32))
    ref = np.asarray(vjp(jnp.asarray(dy))[0])
    model = dx3_by_parity if kind == "3x3" else dx1_by_parity
    got = model(torch.from_numpy(dy), torch.from_numpy(k), 2, h, w).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# The schedule of the kernel
# ---------------------------------------------------------------------------


def schedule_model(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, m1, v1, m2, v2, m3, v3,
                   gout, stride, eps):
    """The backward in the kernel's order and storage dtypes. Returns the
    gradients in ``bottleneck_bwd_reference``'s order and the staged
    tensors ``{"a1", "a2", "dz"}`` as stored (compute dtype)."""
    cdt = x.dtype
    n, hi, wi, _ = x.shape
    ho, wo = hi // stride, wi // stride
    count1, count2 = n * hi * wi, n * ho * wo
    xw, k1, k2, k3 = (fc._wide(t) for t in (x, k1, k2, k3))
    store = (lambda t: t.to(cdt)) if cdt == torch.bfloat16 else (lambda t: t)
    rs1, sc1, sh1 = fc._fold(m1, v1, g1, b1, eps)
    rs2, sc2, sh2 = fc._fold(m2, v2, g2, b2, eps)
    rs3, sc3, sh3 = fc._fold(m3, v3, g3, b3, eps)
    # the recomputed forward: y in fp32, the next operand in the compute dtype
    y1 = fc._conv(xw, k1)
    a1 = store(torch.relu(y1 * sc1 + sh1))
    y2 = fc._conv(fc._wide(a1), k2, stride)
    a2 = store(torch.relu(y2 * sc2 + sh2))
    y3 = fc._conv(fc._wide(a2), k3)
    if short is not None:
        ks, gs, bs, ms, vs = short
        ks = fc._wide(ks)
        rss, scs, shs = fc._fold(ms, vs, gs, bs, eps)
        ys = fc._conv(xw, ks, stride)
    # stage 3, pass 1: z in registers, dz stored, the sums
    z = y3 * sc3 + sh3 + (ys * scs + shs if short is not None else xw)
    dz = store(fc._wide(gout) * (torch.relu(z) > 0))
    dzw = fc._wide(dz)
    yh3 = (y3 - m3) * rs3
    db3, dg3 = dzw.sum(dim=(0, 1, 2)), (dzw * yh3).sum(dim=(0, 1, 2))
    # pass 2: the cotangents in the compute dtype
    dy3 = store(rs3 * g3 * (dzw - db3 / count2 - yh3 * dg3 / count2))
    dk3 = fc._conv_dw(fc._wide(a2), fc._wide(dy3), k3.shape, 1)
    if short is not None:
        yhs = (ys - ms) * rss
        dgs = (dzw * yhs).sum(dim=(0, 1, 2))
        dys = store(rss * gs * (dzw - db3 / count2 - yhs * dgs / count2))
        dks = fc._conv_dw(xw, fc._wide(dys), ks.shape, stride)
    # stage 2
    da2 = fc._wide(dy3) @ k3.T
    dp2 = da2 * ((y2 - m2) * rs2 * g2 + b2 > 0)
    dy2, dg2, db2 = fc._bn_bwd(dp2, (y2 - m2) * rs2, rs2, g2, count2)
    dy2 = store(dy2)
    dk2 = fc._conv_dw(fc._wide(a1), fc._wide(dy2), k2.shape, stride)
    # stage 1: the transposed 3x3/s by parity class
    da1 = dx3_by_parity(fc._wide(dy2), k2, stride, hi, wi)
    dp1 = da1 * ((y1 - m1) * rs1 * g1 + b1 > 0)
    dy1, dg1, db1 = fc._bn_bwd(dp1, (y1 - m1) * rs1, rs1, g1, count1)
    dy1 = store(dy1)
    dk1 = fc._conv_dw(xw, fc._wide(dy1), k1.shape, 1)
    # dx: dy1 k1^T plus dz (identity) or the shortcut's even-even share
    dx = dx1_by_parity(fc._wide(dy1), k1, 1, hi, wi)
    grads = (dk1.to(cdt), dg1, db1, dk2.to(cdt), dg2, db2, dk3.to(cdt), dg3, db3)
    staged = {"a1": a1, "a2": a2, "dz": dz}
    if short is None:
        return ((dx + dzw).to(cdt),) + grads, staged
    dx = dx + dx1_by_parity(fc._wide(dys), ks, stride, hi, wi)
    return (dx.to(cdt),) + grads + (dks.to(cdt), dgs, db3), staged


def _schedule_inputs(n, h, w, cin, p, stride, dtype, seed=21):
    """The block's arguments in ``bottleneck_bwd`` order (moments from the
    plain forward, ``gout`` a draw) in compute dtype ``dtype``."""
    rng = np.random.default_rng(seed)
    proj = stride != 1 or cin != 4 * p
    x = _rand(rng, (n, h, w, cin))
    k1, k3 = _rand(rng, (cin, p), cin ** -0.5), _rand(rng, (p, 4 * p), p ** -0.5)
    k2 = _rand(rng, (3, 3, p, p), (9 * p) ** -0.5)
    bn = [(_rand(rng, (c,), 0.2, 1.0), _rand(rng, (c,), 0.1)) for c in (p, p, 4 * p)]
    short = ((_rand(rng, (cin, 4 * p), cin ** -0.5),) + (_rand(rng, (4 * p,), 0.2, 1.0),
                                                          _rand(rng, (4 * p,), 0.1))
             if proj else None)
    if dtype != torch.float64:
        x, k1, k2, k3 = (t.float().to(dtype) for t in (x, k1, k2, k3))
        bn = [(g.float(), b.float()) for g, b in bn]
        if short is not None:
            short = (short[0].float().to(dtype), short[1].float(), short[2].float())
    (g1, b1), (g2, b2), (g3, b3) = bn
    fwd = fc.bottleneck_fwd_reference(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, EPS)
    gout = _rand(rng, tuple(fwd[0].shape))
    gout = gout if dtype == torch.float64 else gout.float().to(dtype)
    short_b = short + tuple(fwd[7:9]) if short is not None else None
    return (x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short_b, *fwd[1:7], gout, stride, EPS)


@pytest.mark.parametrize("geo", SCHEDULE_GEOMETRIES)
def test_schedule_model_matches_reference_in_float64(geo):
    args = _schedule_inputs(*geo, torch.float64)
    got, _ = schedule_model(*args)
    ref = fc.bottleneck_bwd_reference(*args)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("geo", SCHEDULE_GEOMETRIES)
def test_schedule_model_meets_the_bf16_pins(geo):
    args = _schedule_inputs(*geo, torch.bfloat16)
    got, _ = schedule_model(*args)
    ref = fc.bottleneck_bwd_reference(*args)
    bound = chip_smoke.BF16_REL_L2["grad"]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert chip_smoke.rel_l2(a, b) <= bound
        scaled, cos = chip_smoke.bf16_measure(a, b)
        assert chip_smoke.bf16_ok("grad", scaled, cos)


@pytest.mark.parametrize("geo", SCHEDULE_GEOMETRIES)
def test_staged_operands_are_the_plain_forms_rounded_values(geo):
    """``a1``/``a2`` are the forward plain form's rounded conv operands
    (``rnd(relu(y * s + t))`` from the saved moments), and ``dz`` is the
    backward plain form's ``gout * (z > 0)``, bitwise: bf16 values where
    the plain forms round them to bf16, and ``dz`` exact."""
    args = _schedule_inputs(*geo, torch.bfloat16)
    (x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, m1, v1, m2, v2, m3, v3, gout, stride,
     eps) = args
    _, staged = schedule_model(*args)
    cdt = torch.bfloat16
    _, s1, t1 = fc._fold(m1, v1, g1, b1, eps)
    _, s2, t2 = fc._fold(m2, v2, g2, b2, eps)
    y1 = fc._conv(fc._wide(x), fc._wide(k1))
    a1 = fc._rnd(torch.relu(y1 * s1 + t1), cdt)
    y2 = fc._conv(a1, fc._wide(k2), stride)
    a2 = fc._rnd(torch.relu(y2 * s2 + t2), cdt)
    assert staged["a1"].dtype == cdt and staged["dz"].dtype == cdt
    assert torch.equal(staged["a1"].float(), a1)
    assert torch.equal(staged["a2"].float(), a2)
    # dz as bottleneck_bwd_reference forms it
    rs3 = torch.rsqrt(v3 + eps)
    z = ((fc._conv(a2, fc._wide(k3)) - m3) * rs3) * g3 + b3
    if short is None:
        z = z + fc._wide(x)
    else:
        ks, gs, bs, ms, vs = short
        z = z + ((fc._conv(fc._wide(x), fc._wide(ks), stride) - ms) * torch.rsqrt(vs + eps)) * gs + bs
    dz = fc._wide(gout) * (z > 0)
    assert torch.equal(staged["dz"].float(), dz)


def test_supports_bottleneck_admits_recipe_and_ragged_geometries():
    geos = [geo for _, _, geo in chip_smoke.model_sites("resnet50")]
    geos += [geo for _, geo in chip_smoke.RAGGED_BOTTLENECKS]
    geos += [(n, h, w, cin, p, 1) for n, h, w, cin, p in STRIDE2_GEOMETRIES]
    geos += [(n, h, w, cin, p, 2) for n, h, w, cin, p in STRIDE2_GEOMETRIES]
    geos += SCHEDULE_GEOMETRIES
    for n, h, w, cin, p, stride in geos:
        for dtype in fc.COMPUTE_DTYPES:
            assert fc.supports_bottleneck(n, h, w, p, stride=stride, in_channels=cin,
                                          dtype=dtype), (n, h, w, cin, p, stride)


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    for src in native.CSRC_DIR.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    headers = native.included_headers(tmp_path / "fused_conv_bn.cu")
    assert [h.name for h in headers] == ["conv_gemm_sm90.cuh"]
    before = native.library_path("fused_conv_bn")
    (tmp_path / "unused.cuh").write_text("// still not included\n")
    assert native.library_path("fused_conv_bn") == before
    header = tmp_path / "conv_gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert native.library_path("fused_conv_bn") != before
