"""The port's fused BasicBlock and projection-block ops and the ResNet-10
``--conv_impl fused`` path against the JAX package's Pallas kernels
(interpret mode) and against the port's eager modules.

- ``fused_basic_block`` / ``fused_projection_block`` against
  ``pallas_conv.fused_basic_block`` / ``fused_projection_block`` with
  ``interpret=True``, at the JAX tests' own geometries
  (``tests/test_pallas_conv.py``: ``BLOCK_GEOMETRIES``, ``PROJ_GEOMETRIES``;
  stride 1 and 2, both ``kernel_sc`` shapes): value, the returned moments
  and every gradient (``jax.grad`` against autograd through the port's
  ``torch.autograd.Function``, whose CPU backward is the plain backward
  form). Pins are the JAX package's: values and moments rtol/atol 3e-5,
  gradients rtol 1e-4 / atol 1e-3.
- The plain backward forms against autograd through the plain forwards,
  in float64.
- The ``supports_block`` gate and the identity-geometry rejection of the
  projection op.
- A ResNet-10 SupConResNet with ``conv_impl='fused'`` (plain forms: one
  identity and three projection sites) against the JAX
  ``SupConResNet(conv_impl='pallas')`` in interpret mode at 16 px and 8
  rows, with the pins of the ResNet-50 encoder test; its gradients equal to
  the eager path's in float64; one train step fused against eager.

Inputs are numpy draws from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops import pallas_conv
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.models.resnet import fused_site_plan
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    SupConStepConfig,
    train_step,
)
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()

VAL_RTOL, VAL_ATOL = 3e-5, 3e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
# Per-tensor relative L2 pin of the encoder gradients and step updates: the
# fp32 gradient of a CIFAR ResNet at 16 px and 8 rows is ill-conditioned on
# every implementation (test_torch_port_conv.py, ENCODER_GRAD_REL_L2).
ENCODER_GRAD_REL_L2 = 5e-2

# (n, h, w, c): tests/test_pallas_conv.py BLOCK_GEOMETRIES
BLOCK_GEOMETRIES = [(16, 8, 8, 8), (8, 10, 6, 16), (16, 4, 4, 24), (12, 8, 8, 8)]
# (n, h, w, cin, c, stride): tests/test_pallas_conv.py PROJ_GEOMETRIES, each
# with one of the two kernel_sc shapes the ops take
PROJ_GEOMETRIES = [
    (16, 8, 8, 8, 16, 2, "hwio"), (8, 6, 6, 8, 24, 1, "2d"),
    (8, 10, 6, 16, 16, 2, "2d"), (12, 8, 8, 8, 16, 2, "hwio"),
]
BASIC_GRADS = ("dx", "dk1", "dg1", "db1", "dk2", "dg2", "db2")
PROJ_GRADS = BASIC_GRADS + ("dk_sc", "dg_sc", "db_sc")


def _draw(seed, shapes):
    """numpy float32 draws ``(shape, scale, shift)`` from one seed."""
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        for shape, scale, shift in shapes
    ]


def _block_arrays(seed, n, h, w, cin, c, sc_shape=None):
    """x, k1, g1, b1, k2, g2, b2, then (with ``sc_shape``) k_sc, g_sc, b_sc,
    at the JAX tests' scales."""
    shapes = [((n, h, w, cin), 1.0, 0.0), ((3, 3, cin, c), 0.2, 0.0), ((c,), 1.0, 1.0),
              ((c,), 0.1, 0.0), ((3, 3, c, c), 0.2, 0.0), ((c,), 1.0, 1.0), ((c,), 0.1, 0.0)]
    if sc_shape is not None:
        shapes += [(sc_shape, 0.3, 0.0), ((c,), 1.0, 1.0), ((c,), 0.1, 0.0)]
    return _draw(seed, shapes)


def _loss_t(out):
    return (out * torch.cos(out)).sum()


def _loss_j(out):
    return jnp.sum(out * jnp.cos(out))


def _close(got, want, rtol, atol, name=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=name,
    )


def _compare_with_pallas(arrays, jax_call, port_call, out_names, grad_names):
    jargs = [jnp.asarray(a) for a in arrays]

    def jloss(*a):
        res = jax_call(*a)
        return _loss_j(res[0]), res

    (_, res_j), grads_j = jax.value_and_grad(
        jloss, argnums=tuple(range(len(jargs))), has_aux=True)(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    res_t = port_call(*targs)
    assert len(res_t) == len(res_j) == len(out_names)
    assert not any(m.requires_grad for m in res_t[1:])
    _loss_t(res_t[0]).backward()
    for name, got, want in zip(out_names, res_t, res_j):
        _close(got, want, VAL_RTOL, VAL_ATOL, name)
    for name, t, gj in zip(grad_names, targs, grads_j):
        assert t.grad.shape == t.shape, name
        _close(t.grad, gj, GRAD_RTOL, GRAD_ATOL, name)


@pytest.mark.parametrize("n,h,w,c", BLOCK_GEOMETRIES)
def test_basic_block_matches_pallas_value_moments_and_grads(n, h, w, c):
    assert fused_conv.supports_block(n, h, w, c)
    _compare_with_pallas(
        _block_arrays(n + h + w + c, n, h, w, c, c),
        lambda *a: pallas_conv.fused_basic_block(*a, interpret=True),
        fused_conv.fused_basic_block,
        ("out", "m1", "v1", "m2", "v2"), BASIC_GRADS,
    )


@pytest.mark.parametrize("n,h,w,cin,c,stride,sc", PROJ_GEOMETRIES)
def test_projection_block_matches_pallas_value_moments_and_grads(n, h, w, cin, c, stride, sc):
    assert fused_conv.supports_block(n, h, w, c, stride=stride, in_channels=cin)
    sc_shape = (1, 1, cin, c) if sc == "hwio" else (cin, c)
    _compare_with_pallas(
        _block_arrays(n + h + w + cin + c, n, h, w, cin, c, sc_shape),
        lambda *a: pallas_conv.fused_projection_block(*a, stride=stride, interpret=True),
        lambda *a: fused_conv.fused_projection_block(*a, stride=stride),
        ("out", "m1", "v1", "m2", "v2", "m_sc", "v_sc"), PROJ_GRADS,
    )


@pytest.mark.parametrize("n,h,w,cin,c,stride", [
    (4, 5, 7, 6, 6, 1), (4, 5, 7, 6, 10, 1), (4, 6, 8, 6, 10, 2),
])
def test_block_backward_forms_match_autograd(n, h, w, cin, c, stride):
    """The plain backward forms (the Pallas backward's algebra) against
    autograd through the plain forwards, in float64 so only the algebra can
    differ: the identity block, and the projection block at stride 1 and 2."""
    proj = stride != 1 or cin != c
    arrays = _block_arrays(17, n, h, w, cin, c, (cin, c) if proj else None)
    args = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    if proj:
        res = fused_conv.proj_block_fwd_reference(*args, stride, 1e-5)
    else:
        res = fused_conv.basic_block_fwd_reference(*args, 1e-5)
    gout = torch.from_numpy(_draw(3, [(tuple(res[0].shape), 1.0, 0.0)])[0]).double()
    auto = torch.autograd.grad(res[0], args, gout)
    plain_args = [a.detach() for a in args] + [m.detach() for m in res[1:]] + [gout]
    if proj:
        plain = fused_conv.proj_block_bwd_reference(*plain_args, stride, 1e-5)
        order = (0, 1, 4, 7, 2, 3, 5, 6, 8, 9)  # (dx, dk1, dk2, dks, dg1, ...) -> args
    else:
        plain = fused_conv.basic_block_bwd_reference(*plain_args, 1e-5)
        order = (0, 1, 4, 2, 3, 5, 6)
    for got, i in zip(plain, order):
        np.testing.assert_allclose(got.numpy(), auto[i].numpy(), rtol=1e-9, atol=1e-9)


def test_supports_block_gate_and_rejections():
    ok = fused_conv.supports_block
    for s in fused_site_plan("resnet18", 512, 32)[1:]:
        assert ok(512, s["h"], s["w"], s["width"], stride=s["stride"],
                  in_channels=s["in_channels"]), s["name"]
    assert ok(8, 2, 2, 512, stride=2, in_channels=256)  # no h, w >= 3 rule: no pad scratch
    assert ok(8, 5, 7, 16)
    assert not ok(8, 5, 8, 16, stride=2, in_channels=8)  # odd dims at stride 2
    assert not ok(8, 8, 8, 16, stride=3, in_channels=8)
    assert not ok(0, 8, 8, 16)
    assert not ok(2**20, 64, 64, 512)  # 32-bit index range
    x, k1, g1, b1, k2, g2, b2, ks, gs, bs = (
        torch.from_numpy(a) for a in _block_arrays(2, 2, 4, 4, 8, 8, (8, 8)))
    with pytest.raises(ValueError, match="use fused_basic_block"):
        fused_conv.fused_projection_block(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, stride=1)
    odd = [torch.from_numpy(a) for a in _block_arrays(2, 2, 5, 5, 8, 16, (8, 16))]
    with pytest.raises(ValueError, match="does not admit"):
        fused_conv.fused_projection_block(*odd, stride=2)
    wide = [torch.from_numpy(a) for a in _block_arrays(2, 2, 4, 4, 8, 16)]
    with pytest.raises(ValueError, match="a projection geometry; the identity BasicBlock kernels"):
        fused_conv.fused_basic_block(*wide)
    with pytest.raises(ValueError, match="an identity geometry; the projection BasicBlock kernels"):
        fused_conv.proj_fwd(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, 1, 1e-5)


def test_cpu_calls_leave_the_block_launch_counters_alone():
    names = ("basic_fwd_launches", "basic_bwd_launches", "proj_fwd_launches",
             "proj_bwd_launches")
    before = [getattr(fused_conv, name) for name in names]
    basic = [torch.from_numpy(a).requires_grad_() for a in _block_arrays(3, 2, 4, 4, 8, 8)]
    _loss_t(fused_conv.fused_basic_block(*basic)[0]).backward()
    proj = [torch.from_numpy(a).requires_grad_() for a in _block_arrays(3, 2, 4, 4, 8, 16, (8, 16))]
    _loss_t(fused_conv.fused_projection_block(*proj, stride=2)[0]).backward()
    assert [getattr(fused_conv, name) for name in names] == before


# ---------------------------------------------------------------- encoder


def _perturbed_port_model(conv_impl, seed):
    """An rn10 SupConResNet with seeded BN affines and running statistics."""
    torch.manual_seed(seed)
    model = SupConResNet("resnet10", "mlp", 16)
    model.encoder.set_conv_impl(conv_impl)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return model


def test_rn10_fused_sites_at_16px():
    """At 16 px and 8 rows the port fuses all four rn10 BasicBlock sites.
    The JAX package's fp32 gate fuses the first two (the identity site and
    layer2's projection) and leaves layer3/4's projections to XLA: their
    weights alone pass its VMEM budget. So the encoder comparison below
    holds the port's kernels' plain forms against the Pallas kernels at two
    sites and against XLA's convs at two."""
    sites = fused_site_plan("resnet10", 8, 16)
    assert all(s["admitted"] for s in sites)
    assert [s["kind"] for s in sites] == ["stem", "basic", "proj", "proj", "proj"]
    jax_admits = [pallas_conv.supports_block(8, s["h"], s["w"], s["width"], stride=s["stride"],
                                             in_channels=s["in_channels"]) for s in sites[1:]]
    assert jax_admits == [True, True, False, False]


def test_rn10_fused_encoder_matches_pallas_encoder():
    port = _perturbed_port_model("fused", 3)
    variables = state_dict_to_variables(port.state_dict())
    (x,) = _draw(11, [((8, 16, 16, 3), 1.0, 0.0)])
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=16,
                             conv_impl="pallas")

    def jloss(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
        )
        return _loss_j(out), (out, mut)

    (_, (out_j, mut_j)), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"])
    )

    port.train()
    out_t = port(torch.from_numpy(x))
    _loss_t(out_t).backward()
    _close(out_t, out_j, 1e-4, 1e-4, "projection")
    ours = port.state_dict()
    stats_j = variables_to_state_dict({"params": variables["params"],
                                       "batch_stats": mut_j["batch_stats"]})
    grads_sd = variables_to_state_dict({"params": grads_j,
                                        "batch_stats": mut_j["batch_stats"]})
    buffers = [k for k in stats_j if k.endswith(("running_mean", "running_var"))]
    for key in buffers:
        _close(ours[key], stats_j[key].numpy(), 1e-4, 1e-4, key)
    named = dict(port.named_parameters())
    for key, p in named.items():
        ref = grads_sd[key].numpy().astype(np.float64)
        err = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref) / np.linalg.norm(ref)
        assert err <= ENCODER_GRAD_REL_L2, (key, err)
    # stem + 4 blocks x 2 BNs + 3 shortcut BNs; their weights, the convs, the head
    assert len(buffers) == 2 * 12 and len(named) == 12 * 2 + 8 + 4 + 4


def test_rn10_fused_gradients_exact_in_float64():
    """The fused path's plain forms give the eager modules' gradients and BN
    buffers to float64 rounding."""
    (x,) = _draw(11, [((8, 16, 16, 3), 1.0, 0.0)])
    grads, buffers = {}, {}
    for impl in ("eager", "fused"):
        model = _perturbed_port_model(impl, 3).double().train()
        _loss_t(model(torch.from_numpy(x).double())).backward()
        grads[impl] = {k: p.grad.numpy() for k, p in model.named_parameters()}
        buffers[impl] = {k: b.numpy() for k, b in model.named_buffers()}
    for key, ref in grads["eager"].items():
        err = np.linalg.norm(grads["fused"][key] - ref) / np.linalg.norm(ref)
        assert err <= 1e-10, (key, err)
    for key, ref in buffers["eager"].items():
        np.testing.assert_allclose(buffers["fused"][key], ref, rtol=1e-10, atol=1e-12,
                                   err_msg=key)


def test_rn10_one_step_fused_matches_eager():
    """One train step from one init on one batch, rn10 at 16 px: the fused
    conv path (plain forms) against the eager modules. The loss binds at rel
    1e-4, the BN buffers at 1e-4, each parameter's update in relative L2 at
    ``ENCODER_GRAD_REL_L2``."""
    (views,) = _draw(14, [((4, 2, 16, 16, 3), 1.0, 0.0)])
    labels = torch.arange(4, dtype=torch.int32)
    init = _perturbed_port_model("eager", 6).state_dict()
    params = {k for k, _ in _perturbed_port_model("eager", 6).named_parameters()}
    losses, states = {}, {}
    for impl in ("eager", "fused"):
        model = _perturbed_port_model(impl, 6)
        st = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.1)
        cfg = SupConStepConfig(loss_impl="dense", epochs=1, steps_per_epoch=1)
        losses[impl] = train_step(st, cfg, torch.from_numpy(views), labels)["loss"].item()
        states[impl] = model.state_dict()
    assert abs(losses["fused"] - losses["eager"]) <= 1e-4 * abs(losses["eager"])
    for key, ref in states["eager"].items():
        if key in params:
            upd = (ref - init[key]).double()
            err = ((states["fused"][key] - init[key]).double() - upd).norm() / upd.norm()
            assert err <= ENCODER_GRAD_REL_L2, (key, float(err))
        elif ref.is_floating_point():
            _close(states["fused"][key], ref.numpy(), 1e-4, 1e-4, key)
        else:
            assert torch.equal(states["fused"][key], ref), key
