"""The port's fused conv+BN ops and the ``--conv_impl`` path against the JAX
package's Pallas conv kernels (interpret mode) and against each other.

- The stem and the Bottleneck (identity; stride-2 projection; stride-1
  projection on a non-square grid, the geometries of
  ``tests/test_pallas_conv.py``) against ``pallas_conv.fused_conv_bn_relu``
  / ``fused_bottleneck_block`` with ``interpret=True``: value, the returned
  moments and every gradient (``jax.grad`` against autograd through the
  port's ``torch.autograd.Function``, whose CPU backward is the plain
  backward form). Pins are the JAX package's own (``test_pallas_conv.py``):
  values and moments rtol/atol 3e-5, gradients rtol 1e-4 / atol 1e-3.
- The plain backward forms against autograd through the plain forwards.
- The running-stat update against the JAX package's, and against
  ``nn.BatchNorm2d``'s own train-mode update.
- A ResNet-50 SupConResNet with ``conv_impl='fused'`` (plain forms) against
  the JAX ``SupConResNet(conv_impl='pallas')`` in interpret mode, at 16 px
  and 8 rows: projection, BN buffers (rtol/atol 1e-4) and parameter
  gradients (rtol/atol 1e-3).
- State dicts that do not depend on the conv path, the ``--conv_impl``
  ladder and its banner, the admission gates and ``fused_site_plan``.

Inputs are numpy draws from fixed seeds. A last test runs the CUDA kernels
against their plain forms on the card; it is marked ``cuda`` and skips
where no card is present.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.models.norm import (
    running_stats_update as jax_running_stats_update,
)
from simclr_pytorch_distributed_tpu.ops import pallas_conv
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.models.norm import (
    apply_running_update,
    running_stats_update,
)
from simclr_pytorch_distributed_tpu_torch.models.resnet import fused_site_plan
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    SupConStepConfig,
    train_step,
)
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)

VAL_RTOL, VAL_ATOL = 3e-5, 3e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3


def _draw(seed, shapes):
    """numpy float32 draws ``(shape, scale, shift)`` from one seed."""
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        for shape, scale, shift in shapes
    ]


def _loss_t(out):
    return (out * torch.cos(out)).sum()


def _loss_j(out):
    return jnp.sum(out * jnp.cos(out))


def _close(got, want, rtol, atol, name=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=name,
    )


# ---------------------------------------------------------------- stem


def _stem_arrays(seed, n=8, h=8, w=8, cin=3, cout=16):
    return _draw(seed, [((n, h, w, cin), 1.0, 0.0), ((3, 3, cin, cout), 0.2, 0.0),
                        ((cout,), 1.0, 1.0), ((cout,), 0.1, 0.0)])


def test_stem_matches_pallas_value_moments_and_grads():
    arrays = _stem_arrays(0)
    jargs = [jnp.asarray(a) for a in arrays]
    out_j, m_j, v_j = pallas_conv.fused_conv_bn_relu(*jargs, interpret=True)
    grads_j = jax.grad(
        lambda *a: _loss_j(pallas_conv.fused_conv_bn_relu(*a, interpret=True)[0]),
        argnums=(0, 1, 2, 3),
    )(*jargs)

    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out_t, m_t, v_t = fused_conv.fused_conv_bn_relu(*targs)
    assert not m_t.requires_grad and not v_t.requires_grad
    _loss_t(out_t).backward()
    for name, got, want in (("out", out_t, out_j), ("mean", m_t, m_j), ("var", v_t, v_j)):
        _close(got, want, VAL_RTOL, VAL_ATOL, name)
    for name, t, gj in zip(("dx", "dk", "dgamma", "dbeta"), targs, grads_j):
        _close(t.grad, gj, GRAD_RTOL, GRAD_ATOL, name)


def test_stem_backward_skips_dx_when_not_needed():
    x, k, g, b = (torch.from_numpy(a) for a in _stem_arrays(1))
    k.requires_grad_()
    out, _, _ = fused_conv.fused_conv_bn_relu(x, k, g, b)
    _loss_t(out).backward()
    assert x.grad is None and k.grad is not None
    _, m, v = fused_conv.stem_fwd_reference(x, k.detach(), g, b, 1e-5)
    gout = torch.ones_like(out)
    dx, dk, _, _ = fused_conv.stem_bwd_reference(x, k.detach(), g, b, m, v, gout, 1e-5,
                                                 need_dx=False)
    assert dx is None and dk.shape == k.shape


# ---------------------------------------------------------------- bottleneck

# identity (in == 4*planes, stride 1), stride-2 projection, stride-1
# channel-change projection on a non-square grid (test_pallas_conv.py:407-409)
BOTTLENECK_GEOMETRIES = [
    (8, 8, 8, 32, 8, 1), (8, 8, 8, 16, 8, 2), (8, 10, 6, 16, 8, 1),
]


def _bottleneck_arrays(seed, n, h, w, cin, p):
    """The ten main-path arrays, then the three shortcut arrays."""
    c4 = 4 * p
    return _draw(seed, [((n, h, w, cin), 1.0, 0.0), ((cin, p), 0.3, 0.0), ((p,), 1.0, 1.0),
              ((p,), 0.1, 0.0), ((3, 3, p, p), 0.2, 0.0), ((p,), 1.0, 1.0),
              ((p,), 0.1, 0.0), ((p, c4), 0.3, 0.0), ((c4,), 1.0, 1.0), ((c4,), 0.1, 0.0),
        ((cin, c4), 0.3, 0.0), ((c4,), 1.0, 1.0), ((c4,), 0.1, 0.0)])


@pytest.mark.parametrize("n,h,w,cin,p,stride", BOTTLENECK_GEOMETRIES)
def test_bottleneck_matches_pallas_value_moments_and_grads(n, h, w, cin, p, stride):
    proj = stride != 1 or cin != 4 * p
    arrays = _bottleneck_arrays(n + h + w + cin, n, h, w, cin, p)[: 13 if proj else 10]
    assert fused_conv.supports_bottleneck(n, h, w, p, stride=stride, in_channels=cin)

    def jax_call(*a):
        return pallas_conv.fused_bottleneck_block(
            *a[:10], a[10:] if proj else None, stride=stride, interpret=True
        )

    jargs = [jnp.asarray(a) for a in arrays]
    res_j = jax_call(*jargs)
    grads_j = jax.grad(lambda *a: _loss_j(jax_call(*a)[0]),
                       argnums=tuple(range(len(jargs))))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    res_t = fused_conv.fused_bottleneck_block(
        *targs[:10], tuple(targs[10:]) if proj else None, stride=stride
    )
    assert len(res_t) == len(res_j) == (9 if proj else 7)
    _loss_t(res_t[0]).backward()
    names = ("out", "m1", "v1", "m2", "v2", "m3", "v3", "m_sc", "v_sc")
    for name, got, want in zip(names, res_t, res_j):
        _close(got, want, VAL_RTOL, VAL_ATOL, name)
    gnames = ("dx", "dk1", "dg1", "db1", "dk2", "dg2", "db2", "dk3", "dg3", "db3",
              "dk_sc", "dg_sc", "db_sc")
    for name, t, gj in zip(gnames, targs, grads_j):
        _close(t.grad, gj, GRAD_RTOL, GRAD_ATOL, name)


@pytest.mark.parametrize("n,h,w,cin,p,stride", BOTTLENECK_GEOMETRIES)
def test_bottleneck_backward_form_matches_autograd(n, h, w, cin, p, stride):
    """The plain backward (the Pallas backward's algebra) against autograd
    through the plain forward, with float64 inputs so only the algebra
    can differ."""
    proj = stride != 1 or cin != 4 * p
    arrays = _bottleneck_arrays(7, n, h, w, cin, p)[: 13 if proj else 10]
    args = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    short = tuple(args[10:]) if proj else None
    res = fused_conv.bottleneck_fwd_reference(*args[:10], short, stride, 1e-5)
    gout = torch.from_numpy(_draw(3, [(tuple(res[0].shape), 1.0, 0.0)])[0]).double()
    auto = torch.autograd.grad(res[0], args, gout)
    moments = [r.detach() for r in res[1:]]
    short_b = tuple(a.detach() for a in args[10:]) + tuple(moments[6:]) if proj else None
    plain = fused_conv.bottleneck_bwd_reference(
        *(a.detach() for a in args[:10]), short_b, *moments[:6], gout, stride, 1e-5
    )
    for got, want in zip(plain, auto):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)


def test_stem_backward_form_matches_autograd():
    args = [torch.from_numpy(a).double().requires_grad_() for a in _stem_arrays(4, w=6)]
    out, m, v = fused_conv.stem_fwd_reference(*args, 1e-5)
    gout = torch.from_numpy(_draw(5, [(tuple(out.shape), 1.0, 0.0)])[0]).double()
    auto = torch.autograd.grad(out, args, gout)
    plain = fused_conv.stem_bwd_reference(
        *(a.detach() for a in args), m.detach(), v.detach(), gout, 1e-5
    )
    for got, want in zip(plain, auto):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)


def test_bottleneck_rejects_wrong_shortcut_and_geometry():
    arrays = [torch.from_numpy(a) for a in _bottleneck_arrays(2, 2, 4, 4, 32, 8)]
    with pytest.raises(ValueError, match="shortcut"):
        fused_conv.fused_bottleneck_block(*arrays[:10], tuple(arrays[10:]), stride=1)
    odd = [torch.from_numpy(a) for a in _bottleneck_arrays(2, 2, 5, 5, 16, 8)]
    with pytest.raises(ValueError, match="does not admit"):
        fused_conv.fused_bottleneck_block(*odd[:10], tuple(odd[10:]), stride=2)


def test_supports_gates():
    assert fused_conv.supports_stem(512, 32, 32, 3, 64)
    assert not fused_conv.supports_stem(0, 32, 32, 3, 64)
    ok = fused_conv.supports_bottleneck
    assert ok(512, 4, 4, 512, stride=1, in_channels=2048)
    assert ok(512, 32, 32, 128, stride=2, in_channels=256)
    assert not ok(512, 33, 32, 128, stride=2, in_channels=256)
    assert not ok(512, 32, 32, 128, stride=3, in_channels=256)
    assert not ok(2**20, 64, 64, 512, stride=1, in_channels=2048)  # 32-bit index range


def test_dispatch_rejects_other_devices():
    x, k, g, b = (torch.from_numpy(a) for a in _stem_arrays(6))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fused_conv.stem_fwd(x.to("meta"), k, g, b, 1e-5)


def test_cpu_calls_leave_the_launch_counters_alone():
    before = (fused_conv.stem_fwd_launches, fused_conv.stem_bwd_launches,
              fused_conv.bottleneck_fwd_launches, fused_conv.bottleneck_bwd_launches)
    x, k, g, b = (torch.from_numpy(a).requires_grad_() for a in _stem_arrays(8))
    _loss_t(fused_conv.fused_conv_bn_relu(x, k, g, b)[0]).backward()
    after = (fused_conv.stem_fwd_launches, fused_conv.stem_bwd_launches,
             fused_conv.bottleneck_fwd_launches, fused_conv.bottleneck_bwd_launches)
    assert before == after


# ---------------------------------------------------------------- norm


def test_running_stats_update_matches_jax():
    m, v, bm, bv = _draw(9, [((16,), 0.1, 0.0), ((16,), 0.2, 1.0), ((16,), 1.0, 0.0),
                             ((16,), 0.3, 1.0)])
    for count in (1, 2, 512 * 32 * 32):
        got = running_stats_update(*(torch.from_numpy(a) for a in (m, v, bm, bv)), count, 0.1)
        want = jax_running_stats_update(*(jnp.asarray(a) for a in (m, v, bm, bv)), count, 0.1)
        for a, b in zip(got, want):
            _close(a, b, 1e-6, 1e-7)


def test_apply_running_update_matches_batchnorm2d():
    (x,) = _draw(10, [((6, 8, 5, 7), 2.0, 1.0)])
    x = torch.from_numpy(x)
    ref = nn.BatchNorm2d(8).train()
    ref(x)
    bn = nn.BatchNorm2d(8)
    v, m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    apply_running_update(bn, m, v, 6 * 5 * 7)
    _close(bn.running_mean, ref.running_mean.numpy(), 1e-6, 1e-6)
    _close(bn.running_var, ref.running_var.numpy(), 1e-6, 1e-6)
    assert int(bn.num_batches_tracked) == int(ref.num_batches_tracked) == 1


# ---------------------------------------------------------------- encoder


def _perturbed_port_model(model_name, conv_impl, seed):
    torch.manual_seed(seed)
    model = SupConResNet(model_name, "mlp", 16)
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


# Gradient pin of the rn50 encoder comparison. At 16 px and 8 rows the fp32
# gradient of this encoder is ill-conditioned on every implementation:
# against a float64 run of the same weights and batch, the worst per-tensor
# relative L2 error (||g - g64|| / ||g64||) is 1.95e-2 for the port's eager
# path, 1.87e-2 for its fused path, 2.83e-2 for the JAX package's XLA path
# and 1.13e-2 for its Pallas path, and single elements reach 15% of their
# tensor's largest entry (scripts/port_grad_conditioning.py). An
# elementwise 1e-3 pin cannot hold between any two fp32 implementations
# here; the pin is 5e-2 per tensor in relative L2, and the algebra itself
# is pinned exactly by the float64 test below.
ENCODER_GRAD_REL_L2 = 5e-2


def test_rn50_fused_encoder_matches_pallas_encoder():
    port = _perturbed_port_model("resnet50", "fused", 3)
    variables = state_dict_to_variables(port.state_dict())
    (x,) = _draw(11, [((8, 16, 16, 3), 1.0, 0.0)])
    jmodel = JaxSupConResNet(model_name="resnet50", head="mlp", feat_dim=16,
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
    assert len(buffers) == 2 * 53 and len(named) == 163


def test_rn50_fused_gradients_exact_in_float64():
    """The fused path's plain forms give the eager modules' gradients and
    BN buffers to float64 rounding (2.3e-13 per tensor in
    scripts/port_grad_conditioning.py)."""
    (x,) = _draw(11, [((8, 16, 16, 3), 1.0, 0.0)])
    grads, buffers = {}, {}
    for impl in ("eager", "fused"):
        model = _perturbed_port_model("resnet50", impl, 3).double().train()
        _loss_t(model(torch.from_numpy(x).double())).backward()
        grads[impl] = {k: p.grad.numpy() for k, p in model.named_parameters()}
        buffers[impl] = {k: b.numpy() for k, b in model.named_buffers()}
    for key, ref in grads["eager"].items():
        err = np.linalg.norm(grads["fused"][key] - ref) / np.linalg.norm(ref)
        assert err <= 1e-10, (key, err)
    for key, ref in buffers["eager"].items():
        np.testing.assert_allclose(buffers["fused"][key], ref, rtol=1e-10, atol=1e-12,
                                   err_msg=key)


def test_state_dict_and_buffers_do_not_depend_on_conv_impl():
    models = {impl: _perturbed_port_model("resnet50", impl, 4) for impl in ("eager", "fused")}
    sd = {impl: m.state_dict() for impl, m in models.items()}
    assert list(sd["eager"]) == list(sd["fused"])
    for key in sd["eager"]:
        assert torch.equal(sd["eager"][key], sd["fused"][key]), key
    (x,) = _draw(12, [((8, 16, 16, 3), 1.0, 0.0)])
    for m in models.values():
        m.train()
        m(torch.from_numpy(x))
    after = {impl: m.state_dict() for impl, m in models.items()}
    for key, ref in after["eager"].items():
        if key.endswith("num_batches_tracked"):
            assert int(after["fused"][key]) == int(ref) == 1, key
        elif "running" in key:
            _close(after["fused"][key], ref.numpy(), 1e-4, 1e-4, key)


def test_eval_mode_stays_eager():
    models = {impl: _perturbed_port_model("resnet50", impl, 5).eval()
              for impl in ("eager", "fused")}
    (x,) = _draw(13, [((4, 8, 8, 3), 1.0, 0.0)])
    with torch.no_grad():
        outs = [m(torch.from_numpy(x)) for m in models.values()]
    assert torch.equal(outs[0], outs[1])


def test_one_step_fused_matches_eager():
    """One train step from one init on one batch, rn50 at 16 px: the fused
    conv path (plain forms) against the eager modules. The loss binds at
    rel 1e-4 and the BN buffers at 1e-4; each parameter's update binds in
    relative L2 at ``ENCODER_GRAD_REL_L2``, the fp32 gradient noise of this
    geometry (derivation above)."""
    (views,) = _draw(14, [((4, 2, 16, 16, 3), 1.0, 0.0)])
    labels = torch.arange(4, dtype=torch.int32)
    init = _perturbed_port_model("resnet50", "eager", 6).state_dict()
    losses, states = {}, {}
    for impl in ("eager", "fused"):
        model = _perturbed_port_model("resnet50", impl, 6)
        st = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.1)
        cfg = SupConStepConfig(loss_impl="dense", epochs=1, steps_per_epoch=1)
        losses[impl] = train_step(st, cfg, torch.from_numpy(views), labels)["loss"].item()
        states[impl] = model.state_dict()
    assert abs(losses["fused"] - losses["eager"]) <= 1e-4 * abs(losses["eager"])
    params = {k for k, _ in _perturbed_port_model("resnet50", "eager", 6).named_parameters()}
    for key, ref in states["eager"].items():
        if key in params:
            upd = (ref - init[key]).double()
            err = ((states["fused"][key] - init[key]).double() - upd).norm() / upd.norm()
            assert err <= ENCODER_GRAD_REL_L2, (key, float(err))
        elif ref.is_floating_point():
            _close(states["fused"][key], ref.numpy(), 1e-4, 1e-4, key)
        else:
            assert torch.equal(states["fused"][key], ref), key


# ---------------------------------------------------------------- ladder


def test_fused_site_plan_recipe_geometry():
    sites = fused_site_plan("resnet50", 512, 32)
    assert len(sites) == 17 and all(s["admitted"] for s in sites)
    assert [s["kind"] for s in sites] == ["stem"] + ["bottleneck"] * 16
    assert [s["name"] for s in sites if s["stride"] == 2] == [
        "layer2_block0", "layer3_block0", "layer4_block0"]
    assert sites[-1]["desc"] == "layer4_block2[bottleneck] 2048->2048@4x4/s1"
    rn18 = fused_site_plan("resnet18", 512, 32)
    assert len(rn18) == 9 and all(s["admitted"] for s in rn18)
    assert [s["kind"] for s in rn18] == ["stem"] + ["basic", "basic"] + ["proj", "basic"] * 3
    assert [s["desc"] for s in rn18] == [
        "stem 3->64@32x32",
        "layer1_block0[basic] 64->64@32x32/s1", "layer1_block1[basic] 64->64@32x32/s1",
        "layer2_block0[proj] 64->128@32x32/s2", "layer2_block1[basic] 128->128@16x16/s1",
        "layer3_block0[proj] 128->256@16x16/s2", "layer3_block1[basic] 256->256@8x8/s1",
        "layer4_block0[proj] 256->512@8x8/s2", "layer4_block1[basic] 512->512@4x4/s1",
    ]


def test_resolve_conv_impl_ladder():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert supcon.resolve_conv_impl("eager", "resnet50", 256, 32, cuda)[0] == "eager"
    impl, reason = supcon.resolve_conv_impl("auto", "resnet50", 256, 32, cpu)
    assert impl == "eager" and "CUDA only" in reason
    impl, reason = supcon.resolve_conv_impl("auto", "resnet50", 256, 32, cuda)
    assert impl == "fused" and reason.count("bottleneck]") == 16 and "stem 3->64@32x32" in reason
    impl, reason = supcon.resolve_conv_impl("fused", "resnet50", 4, 8, cpu)
    assert impl == "fused" and "plain PyTorch forms" in reason
    impl, reason = supcon.resolve_conv_impl("auto", "resnet50", 0, 32, cuda)
    assert impl == "eager" and "no admitted geometry" in reason
    with pytest.raises(ValueError, match="admits no site"):
        supcon.resolve_conv_impl("fused", "resnet50", 0, 32, cpu)
    banner = config_lib.impl_resolution_banner("conv_impl", "auto", "eager", reason)
    assert banner.startswith("[conv_impl] requested 'auto' -> resolved 'eager': ")


def test_parser_and_build_banner(caplog):
    assert config_lib.parse_supcon([]).conv_impl == "auto"
    cfg = config_lib.parse_supcon(["--conv_impl", "fused", "--model", "resnet10",
                                   "--size", "8", "--batch_size", "4", "--device", "cpu"])
    with caplog.at_level(logging.INFO):
        state, _ = supcon.build(cfg, 1, torch.device("cpu"))
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("[conv_impl]")]
    assert lines == ["[conv_impl] 'fused': explicit request (on cpu the kernels' plain "
                     "PyTorch forms run); fused sites: stem 3->64@8x8, "
                     "layer1_block0[basic] 64->64@8x8/s1, layer2_block0[proj] 64->128@8x8/s2, "
                     "layer3_block0[proj] 128->256@4x4/s2, layer4_block0[proj] 256->512@2x2/s2"]
    assert state.model.encoder.conv_impl == "fused"
    with pytest.raises(SystemExit):
        config_lib.parse_supcon(["--conv_impl", "pallas"])


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_kernels_match_plain_forms_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x, k, g, b = (torch.from_numpy(a).to(dev) for a in _stem_arrays(15, n=6, h=10, w=6))
    got = fused_conv.stem_fwd(x, k, g, b, 1e-5)
    want = fused_conv.stem_fwd_reference(x, k, g, b, 1e-5)
    for a, r in zip(got, want):
        _close(a.cpu(), r.cpu().numpy(), VAL_RTOL, VAL_ATOL)
    gout = torch.ones_like(got[0])
    for a, r in zip(fused_conv.stem_bwd(x, k, g, b, want[1], want[2], gout, 1e-5),
                    fused_conv.stem_bwd_reference(x, k, g, b, want[1], want[2], gout, 1e-5)):
        _close(a.cpu(), r.cpu().numpy(), GRAD_RTOL, GRAD_ATOL)
