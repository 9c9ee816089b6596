"""The port's ``--bf16`` compute against the JAX package's bf16 path.

- Each conv+BN family (stem, Bottleneck identity and projection, BasicBlock,
  projection block): the port's public op on a bf16 ``x`` with fp32
  parameters (on CPU tensors, the bf16 plain forms) against the Pallas op
  in interpret mode on the same inputs, with one bf16 upstream gradient:
  the value, the moments, ``dx`` (bf16), every ``dW`` (bf16-rounded,
  widened to fp32 by both ops) and dgamma/dbeta. Pins are the JAX
  package's round-19 bf16 bounds (``tests/test_pallas_conv.py:49-77``).
  Both sides round at the same points, so they agree far inside them:
  measured, every tensor within 3.0e-3 scaled max error (under one bf16
  ulp, 3.9e-3) with cosine 1.000000 to six places; each family also
  holds to the tighter FAMILY_SCALED / FAMILY_COS, ten times that
  measured error.
- The rn10 encoder under ``--bf16 --conv_impl fused`` (plain forms) against
  the JAX encoder with ``dtype=bf16, conv_impl='pallas'`` (interpret mode)
  at 16 px and 8 rows: the projection, the BN buffers and every parameter
  gradient, at the same pins (measured: projection 4.0e-3, buffers
  1.2e-3, gradients cosine 0.983 or more and scaled max error up to 0.46,
  the ill-conditioned small step of PERF.md's Findings).
- One ``--bf16`` train step of the port (eager conv) against the JAX
  package's jitted step with ``dtype=bf16`` (``xla``) from one transplanted
  init: the loss, every parameter's update, the BN buffers.
- The pretraining entry point under ``--bf16 --device cpu``: the
  ``compute dtype bf16`` banner and a checkpoint that ``utils/convert.py``
  reads back in fp32.
- ``--bf16`` parsing, the gates' dtype argument, the launch operands'
  alignment check, and the head and BN helpers.

Inputs are numpy draws from fixed seeds.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.models.heads import TorchDense
from simclr_pytorch_distributed_tpu.models.norm import CrossReplicaBatchNorm
from simclr_pytorch_distributed_tpu.ops import pallas_conv
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.models.heads import head_forward
from simclr_pytorch_distributed_tpu_torch.models.norm import batch_norm
from simclr_pytorch_distributed_tpu_torch.models.resnet import fused_site_plan
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
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
from torch_threads import limit_threads

limit_threads()

# the JAX package's round-19 bf16 pins (tests/test_pallas_conv.py:56-58)
BF16_VAL_SCALED, BF16_VAL_COS = 2e-2, 0.9999
BF16_GRAD_COS, BF16_GRAD_SCALED = 0.95, 0.5
BF16_STATS_SCALED = 2e-2
# the families against Pallas, both sides rounding at the same points:
# worst measured 3.0e-3 scaled max error, cosine 1.000000 (module docstring)
FAMILY_SCALED, FAMILY_COS = 3e-2, 0.99999


def _np(a):
    """A torch tensor or a JAX array (bf16 included) as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _measure(got, want):
    """``(max |got - want| / max |want|, cosine)`` in float64."""
    a, b = _np(got).ravel(), _np(want).ravel()
    scaled = float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    return scaled, cos


def _assert_bf16(got, want, kind, name=""):
    """The round-19 pin of ``kind`` 'value', 'stats' or 'grad'."""
    scaled, cos = _measure(got, want)
    if kind == "value":
        assert scaled <= BF16_VAL_SCALED and cos >= BF16_VAL_COS, (name, scaled, cos)
    elif kind == "stats":
        assert scaled <= BF16_STATS_SCALED, (name, scaled)
    else:
        assert cos >= BF16_GRAD_COS and scaled <= BF16_GRAD_SCALED, (name, scaled, cos)
    return scaled, cos


def _draw(seed, shapes):
    """numpy float32 draws ``(shape, scale, shift)`` from one seed."""
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        for shape, scale, shift in shapes
    ]


def _bf16_grid(a):
    """``a`` rounded to bf16, as float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- the families


def _compare_family(arrays, jax_op, port_op, out_names, grad_names, seed):
    """x (``arrays[0]``) in bf16 and the parameters in fp32 through both
    ops, then one bf16 cotangent on the output (zeros on the moments)
    through both backwards. Returns the measured ``{name: (scaled, cos)}``."""
    xj = jnp.asarray(arrays[0]).astype(jnp.bfloat16)
    outs_j, vjp = jax.vjp(jax_op, xj, *[jnp.asarray(a) for a in arrays[1:]])
    assert outs_j[0].dtype == jnp.bfloat16 and all(o.dtype == jnp.float32 for o in outs_j[1:])
    gout = _bf16_grid(_draw(seed, [(tuple(outs_j[0].shape), 1.0, 0.0)])[0])
    grads_j = vjp((jnp.asarray(gout).astype(jnp.bfloat16),)
                  + tuple(jnp.zeros_like(o) for o in outs_j[1:]))

    xt = torch.from_numpy(arrays[0]).to(torch.bfloat16).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in arrays[1:]]
    outs_t = port_op(xt, *pt)
    assert outs_t[0].dtype == torch.bfloat16 and all(o.dtype == torch.float32 for o in outs_t[1:])
    outs_t[0].backward(torch.from_numpy(gout).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and all(p.grad.dtype == torch.float32 for p in pt)

    measured = {}
    for name, got, want in zip(out_names, outs_t, outs_j):
        measured[name] = _assert_bf16(got, want, "value" if name == "out" else "stats", name)
    for name, t, gj in zip(grad_names, [xt] + pt, grads_j):
        measured[name] = _assert_bf16(t.grad, gj, "grad", name)
        if name.startswith("dk"):  # both sides' dW are bf16 values widened to fp32
            assert np.array_equal(_bf16_grid(_np(t.grad)), _np(t.grad).astype(np.float32)), name
    return measured


STEM_GRADS = ("dx", "dk", "dg", "db")
BOT_OUT = ("out", "m1", "v1", "m2", "v2", "m3", "v3", "m_sc", "v_sc")
BOT_GRADS = ("dx", "dk1", "dg1", "db1", "dk2", "dg2", "db2", "dk3", "dg3", "db3",
             "dk_sc", "dg_sc", "db_sc")
BLOCK_OUT = ("out", "m1", "v1", "m2", "v2", "m_sc", "v_sc")
BLOCK_GRADS = ("dx", "dk1", "dg1", "db1", "dk2", "dg2", "db2", "dk_sc", "dg_sc", "db_sc")


def test_stem_bf16_matches_pallas_bf16():
    arrays = _draw(0, [((8, 8, 8, 3), 1.0, 0.0), ((3, 3, 3, 16), 0.2, 0.0),
                       ((16,), 1.0, 1.0), ((16,), 0.1, 0.0)])
    measured = _compare_family(
        arrays, lambda *a: pallas_conv.fused_conv_bn_relu(*a, interpret=True),
        fused_conv.fused_conv_bn_relu, ("out", "mean", "var"), STEM_GRADS, 1)
    assert max(s for s, _ in measured.values()) <= FAMILY_SCALED
    assert min(c for _, c in measured.values()) >= FAMILY_COS


@pytest.mark.parametrize("n,h,w,cin,p,stride", [(8, 8, 8, 32, 8, 1), (8, 8, 8, 16, 8, 2)])
def test_bottleneck_bf16_matches_pallas_bf16(n, h, w, cin, p, stride):
    proj = stride != 1 or cin != 4 * p
    c4 = 4 * p
    arrays = _draw(n + cin + stride, [
        ((n, h, w, cin), 1.0, 0.0), ((cin, p), 0.3, 0.0), ((p,), 1.0, 1.0), ((p,), 0.1, 0.0),
        ((3, 3, p, p), 0.2, 0.0), ((p,), 1.0, 1.0), ((p,), 0.1, 0.0),
        ((p, c4), 0.3, 0.0), ((c4,), 1.0, 1.0), ((c4,), 0.1, 0.0),
        ((cin, c4), 0.3, 0.0), ((c4,), 1.0, 1.0), ((c4,), 0.1, 0.0),
    ])[: 13 if proj else 10]
    assert fused_conv.supports_bottleneck(n, h, w, p, stride=stride, in_channels=cin,
                                          dtype=torch.bfloat16)
    measured = _compare_family(
        arrays,
        lambda *a: pallas_conv.fused_bottleneck_block(
            *a[:10], a[10:] if proj else None, stride=stride, interpret=True),
        lambda *a: fused_conv.fused_bottleneck_block(
            *a[:10], tuple(a[10:]) if proj else None, stride=stride),
        BOT_OUT, BOT_GRADS, 2)
    assert len(measured) == (22 if proj else 17)
    assert max(s for s, _ in measured.values()) <= FAMILY_SCALED
    assert min(c for _, c in measured.values()) >= FAMILY_COS


@pytest.mark.parametrize("n,h,w,cin,c,stride", [(8, 8, 8, 8, 8, 1), (8, 8, 8, 8, 16, 2)])
def test_basic_and_projection_block_bf16_match_pallas_bf16(n, h, w, cin, c, stride):
    proj = stride != 1 or cin != c
    shapes = [((n, h, w, cin), 1.0, 0.0), ((3, 3, cin, c), 0.2, 0.0), ((c,), 1.0, 1.0),
              ((c,), 0.1, 0.0), ((3, 3, c, c), 0.2, 0.0), ((c,), 1.0, 1.0), ((c,), 0.1, 0.0)]
    if proj:
        shapes += [((cin, c), 0.3, 0.0), ((c,), 1.0, 1.0), ((c,), 0.1, 0.0)]
    arrays = _draw(n + cin + c, shapes)
    if proj:
        jax_op = lambda *a: pallas_conv.fused_projection_block(  # noqa: E731
            *a, stride=stride, interpret=True)
        port_op = lambda *a: fused_conv.fused_projection_block(*a, stride=stride)  # noqa: E731
    else:
        jax_op = lambda *a: pallas_conv.fused_basic_block(*a, interpret=True)  # noqa: E731
        port_op = fused_conv.fused_basic_block
    measured = _compare_family(arrays, jax_op, port_op, BLOCK_OUT, BLOCK_GRADS, 3)
    assert len(measured) == (17 if proj else 12)
    assert max(s for s, _ in measured.values()) <= FAMILY_SCALED
    assert min(c for _, c in measured.values()) >= FAMILY_COS


def test_bf16_plain_forms_round_where_pallas_rounds():
    """The bf16 plain backward equals the fp32 plain backward run on the
    operands the Pallas kernel rounds (x, k, the upstream gradient) with
    ``dy`` rounded before the products and ``dx``/``dk`` rounded at the end:
    the rounding points, spelled out once more, agree exactly."""
    x, k, g, b = (torch.from_numpy(a) for a in _draw(4, [
        ((4, 6, 6, 3), 1.0, 0.0), ((3, 3, 3, 8), 0.2, 0.0), ((8,), 1.0, 1.0), ((8,), 0.1, 0.0)]))
    xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
    out, m, v = fused_conv.stem_fwd_reference(xb, kb, g, b, 1e-5)
    out32, m32, v32 = fused_conv.stem_fwd_reference(xb.float(), kb.float(), g, b, 1e-5)
    assert out.dtype == torch.bfloat16 and torch.equal(out, out32.to(torch.bfloat16))
    assert torch.equal(m, m32) and torch.equal(v, v32)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    dx, dk, dg, db = fused_conv.stem_bwd_reference(xb, kb, g, b, m, v, gout, 1e-5)
    rs = torch.rsqrt(v + 1e-5)
    yh = (fused_conv._conv(xb.float(), kb.float()) - m) * rs
    dp = gout.float() * (yh * g + b > 0)
    dy, dg32, db32 = fused_conv._bn_bwd(dp, yh, rs, g, 4 * 6 * 6)
    dy = dy.to(torch.bfloat16).float()
    assert torch.equal(dk, fused_conv._conv_dw(xb.float(), dy, k.shape, 1).to(torch.bfloat16))
    assert torch.equal(dx, fused_conv._conv_dx(dy, kb.float(), 1, 6, 6).to(torch.bfloat16))
    assert torch.equal(dg, dg32) and torch.equal(db, db32)


def test_gates_take_the_compute_dtype():
    # no VMEM model: the dtype does not change a gate's answer, and the
    # port admits the same sites in both compute dtypes
    for dtype in (torch.float32, torch.bfloat16):
        assert fused_conv.supports_stem(512, 32, 32, 3, 64, dtype=dtype)
        assert fused_conv.supports_block(512, 16, 16, 256, stride=2, in_channels=128, dtype=dtype)
        assert fused_conv.supports_bottleneck(512, 8, 8, 256, stride=2, in_channels=512,
                                              dtype=dtype)
        assert not fused_conv.supports_block(512, 9, 8, 128, stride=2, in_channels=64,
                                             dtype=dtype)
        assert not fused_conv.supports_bottleneck(512, 32, 32, 64, stride=3, in_channels=64,
                                                  dtype=dtype)
    for model in ("resnet18", "resnet50"):
        fp32 = fused_site_plan(model, 512, 32)
        bf16 = fused_site_plan(model, 512, 32, torch.bfloat16)
        assert [s["admitted"] for s in fp32] == [s["admitted"] for s in bf16]
        assert all(s["admitted"] for s in bf16)
    # a launch computes in fp32 or bf16 only
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="compute in"):
            fused_conv._launch_dtype(torch.zeros(2, 4, 4, 3, dtype=dtype))


def test_launch_operands_must_be_16_byte_aligned():
    # the kernels load x, the weights and the upstream gradient 16 bytes
    # at a time; a contiguous view off that boundary is refused, per-channel
    # rows are not held to it
    base = torch.zeros(2 * 4 * 4 * 8 + 8, dtype=torch.bfloat16)
    x = base[:-8].view(2, 4, 4, 8)
    assert x.data_ptr() % 16 == 0
    fused_conv._check("x", x, (2, 4, 4, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_conv._check("x", base[1:-7].view(2, 4, 4, 8), (2, 4, 4, 8), torch.bfloat16)
    rows = torch.zeros(2, 10)
    fused_conv._check("var", rows[1], (10,))


def test_cpu_bf16_calls_leave_every_launch_counter_alone():
    names = [n for n in vars(fused_conv) if n.endswith("_launches")]
    assert len(names) == 16 and sum(n.endswith("_bf16_launches") for n in names) == 8
    before = [getattr(fused_conv, n) for n in names]
    x, k, g, b = (torch.from_numpy(a) for a in _draw(5, [
        ((2, 4, 4, 3), 1.0, 0.0), ((3, 3, 3, 8), 0.2, 0.0), ((8,), 1.0, 1.0), ((8,), 0.1, 0.0)]))
    out, _, _ = fused_conv.fused_conv_bn_relu(x.to(torch.bfloat16), k.requires_grad_(), g, b)
    out.float().sum().backward()
    assert k.grad.dtype == torch.float32
    assert [getattr(fused_conv, n) for n in names] == before


# ---------------------------------------------------------------- model pieces


def test_batch_norm_and_head_in_bf16_match_jax():
    """BN over a bf16 input (fp32 statistics and buffers, bf16 output) and
    the bf16 MLP head against ``CrossReplicaBatchNorm(dtype=bf16)`` and
    ``TorchDense(dtype=bf16)``."""
    (x,) = _draw(6, [((8, 4, 4, 16), 1.0, 0.5)])
    bn = nn.BatchNorm2d(16).train()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = batch_norm(bn, xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    variables = {"params": {"scale": jnp.ones(16), "bias": jnp.zeros(16)},
                 "batch_stats": {"mean": jnp.zeros(16), "var": jnp.ones(16)}}
    yj, mut = CrossReplicaBatchNorm(dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x).astype(jnp.bfloat16), mutable=["batch_stats"])
    _assert_bf16(y, yj, "value", "bn out")
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    bf16_bn = nn.BatchNorm2d(16).to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 BN parameters and buffers"):
        batch_norm(bf16_bn, xb.permute(0, 3, 1, 2))

    (h,) = _draw(7, [((8, 32), 1.0, 0.0)])
    torch.manual_seed(0)
    head = nn.Sequential(nn.Linear(32, 32), nn.ReLU(), nn.Linear(32, 8))
    out = head_forward(head, torch.from_numpy(h), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    hj = jnp.asarray(h)
    for i in (0, 2):
        lin = head[i]
        params = {"params": {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                             "bias": jnp.asarray(lin.bias.detach().numpy())}}
        hj = TorchDense(lin.out_features, dtype=jnp.bfloat16).apply(params, hj)
        if i == 0:
            hj = jax.nn.relu(hj)
    _assert_bf16(out, hj, "value", "head")
    assert torch.equal(head_forward(head, torch.from_numpy(h), torch.float32),
                       head(torch.from_numpy(h)))


# ---------------------------------------------------------------- encoder


def _perturbed_port_model(conv_impl, seed, feat_dim=16):
    """An rn10 SupConResNet in bf16 compute with seeded BN affines and
    running statistics."""
    torch.manual_seed(seed)
    model = SupConResNet("resnet10", "mlp", feat_dim)
    model.encoder.set_conv_impl(conv_impl).set_compute_dtype(torch.bfloat16)
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


def test_rn10_bf16_fused_encoder_matches_pallas_bf16_encoder():
    """At 16 px and 8 rows the port fuses all four rn10 BasicBlock sites in
    bf16; the JAX package's bf16 gate fuses the first three (bf16 halves
    the VMEM it models, one more site than its fp32 gate) and leaves
    layer4's projection to XLA's bf16 convs."""
    sites = fused_site_plan("resnet10", 8, 16, torch.bfloat16)
    assert all(s["admitted"] for s in sites)
    jax_admits = [pallas_conv.supports_block(8, s["h"], s["w"], s["width"], stride=s["stride"],
                                             in_channels=s["in_channels"], dtype=jnp.bfloat16)
                  for s in sites[1:]]
    assert jax_admits == [True, True, True, False]
    port = _perturbed_port_model("fused", 3)
    variables = state_dict_to_variables(port.state_dict())
    (x,) = _draw(11, [((8, 16, 16, 3), 1.0, 0.0)])
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=16,
                             dtype=jnp.bfloat16, conv_impl="pallas")

    def jloss(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
        )
        outf = out.astype(jnp.float32)
        return jnp.sum(outf * jnp.cos(outf)), (out, mut)

    (_, (out_j, mut_j)), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"])
    )
    port.train()
    out_t = port(torch.from_numpy(x))
    assert out_t.dtype == torch.bfloat16
    outf = out_t.float()
    (outf * torch.cos(outf)).sum().backward()
    _assert_bf16(out_t, out_j, "value", "projection")
    ours = port.state_dict()
    stats_j = variables_to_state_dict({"params": variables["params"],
                                       "batch_stats": mut_j["batch_stats"]})
    grads_sd = variables_to_state_dict({"params": grads_j,
                                        "batch_stats": mut_j["batch_stats"]})
    buffers = [k for k in stats_j if k.endswith(("running_mean", "running_var"))]
    for key in buffers:
        _assert_bf16(ours[key], stats_j[key], "stats", key)
    named = dict(port.named_parameters())
    for key, p in named.items():
        assert p.dtype == p.grad.dtype == torch.float32, key
        _assert_bf16(p.grad, grads_sd[key], "grad", key)
    assert len(buffers) == 2 * 12 and len(named) == 12 * 2 + 8 + 4 + 4


# ---------------------------------------------------------------- the step


def _init_port_model(conv_impl):
    torch.manual_seed(5)
    model = SupConResNet("resnet10", "mlp", 32)
    model.encoder.set_conv_impl(conv_impl).set_compute_dtype(torch.bfloat16)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return model


def test_one_bf16_step_matches_jax():
    """One ``--bf16`` step of the port's eager path (cuDNN-style convs on
    bf16 with the fp32 weights cast per forward, BN on bf16 with fp32
    statistics, the bf16 head) against the JAX package's jitted step with
    ``dtype=bf16`` and the XLA convs, from one transplanted rn10 init at
    16 px: the loss (the values' pin, relative), each parameter's update
    (the gradient pins' cosine) and the BN buffers (the statistics pin).
    (The fused path meets the Pallas path in the encoder test above.)
    Measured: update cosines 0.975 or more, buffers within 1.2e-3. The
    updates are not pinned elementwise: a step at
    16 px and 8 rows is ill-conditioned on every implementation (PERF.md,
    Findings), and single update entries differ by up to 0.53 of their
    tensor's largest between the two frameworks' bf16 steps."""
    conv_impl, jax_conv_impl = "eager", "xla"
    rng = np.random.default_rng(12)
    views = rng.standard_normal((8, 2, 16, 16, 3)).astype(np.float32)
    labels = np.arange(8, dtype=np.int32)
    sched_kwargs = dict(learning_rate=0.1, epochs=1, steps_per_epoch=1, cosine=True)
    step_kwargs = dict(method="SimCLR", temperature=0.5, epochs=1, steps_per_epoch=1,
                       grad_div=2.0, loss_impl="dense")

    model = _init_port_model(conv_impl)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, make_optimizer(model), make_lr_schedule(**sched_kwargs))
    m = train_step(state, SupConStepConfig(**step_kwargs), torch.from_numpy(views),
                   torch.from_numpy(labels))

    variables = state_dict_to_variables(init)
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=32,
                             dtype=jnp.bfloat16, conv_impl=jax_conv_impl)
    schedule = jax_make_lr_schedule(**sched_kwargs)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
    )
    jstep = jax.jit(jax_step.make_train_step(jmodel, tx, schedule,
                                             jax_step.SupConStepConfig(**step_kwargs)))
    jstate, jm = jstep(jstate, jnp.asarray(views), jnp.asarray(labels))

    loss, jloss = m["loss"].item(), float(jm["loss"])
    assert abs(loss - jloss) <= BF16_VAL_SCALED * abs(jloss), (loss, jloss)
    final = variables_to_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ours = model.state_dict()
    params_t = {k for k, _ in model.named_parameters()}
    for key, ref in final.items():
        if key.endswith("num_batches_tracked"):
            continue
        assert ours[key].dtype == torch.float32, key
        if key in params_t:
            _, cos = _measure(ours[key] - init[key], ref - init[key])
            assert cos >= BF16_GRAD_COS, (key, cos)
        else:
            _assert_bf16(ours[key], ref, "stats", key)


# ---------------------------------------------------------------- entry point


def test_bf16_flag_parses():
    assert config_lib.parse_supcon([]).bf16 is False
    assert config_lib.parse_supcon(["--bf16"]).bf16 is True
    assert supcon.compute_dtype(True) == torch.bfloat16
    assert supcon.compute_dtype(False) == torch.float32
    _, reason = supcon.resolve_conv_impl("fused", "resnet18", 4, 8, torch.device("cpu"),
                                         bf16=True)
    assert "compute dtype bf16" in reason
    _, reason = supcon.resolve_conv_impl("eager", "resnet18", 4, 8, torch.device("cpu"),
                                         bf16=True)
    assert "compute dtype bf16" in reason
    _, reason = supcon.resolve_conv_impl("fused", "resnet18", 4, 8, torch.device("cpu"))
    assert "compute dtype" not in reason


def test_bf16_entry_point_run_on_cpu_writes_an_fp32_checkpoint(tmp_path, caplog):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
            "--batch_size", "64", "--epochs", "1", "--loss_impl", "fused", "--conv_impl",
            "fused", "--bf16", "--method", "SimCLR", "--print_freq", "50", "--save_freq", "1",
            "--feat_dim", "32", "--workdir", str(tmp_path)]
    with caplog.at_level(logging.INFO):
        run = supcon.main(argv)
    assert len(run.history) == 28 and all(np.isfinite(h["loss"]) for h in run.history)
    log = open(os.path.join(run.save_folder, "log-ing")).read()
    banner = [line for line in log.splitlines() if "[conv_impl]" in line]
    assert len(banner) == 1 and "compute dtype bf16; fused sites: stem 3->64@8x8" in banner[0]
    assert run.state.model.encoder.compute_dtype == torch.bfloat16
    ckpt = torch.load(os.path.join(run.save_folder, "last.pth"), map_location="cpu",
                      weights_only=True)
    sd = {k[len("module."):]: v for k, v in ckpt["model"].items()}
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    variables = state_dict_to_variables(sd)
    leaves = jax.tree_util.tree_leaves(variables)
    assert leaves and all(np.asarray(v).dtype == np.float32 for v in leaves)
    back = variables_to_state_dict(variables)
    for key, ref in back.items():
        if not key.endswith("num_batches_tracked"):  # not in the JAX tree
            assert torch.equal(sd[key], ref), key
    # the fp32 model reads the bf16 run's checkpoint as it is
    fp32 = SupConResNet("resnet10", "mlp", 32)
    fp32.load_state_dict(sd)
    x = torch.from_numpy(_draw(8, [((4, 8, 8, 3), 1.0, 0.0)])[0])
    with torch.no_grad():
        assert torch.isfinite(fp32.eval()(x)).all()
