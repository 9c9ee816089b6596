"""The redesigned BasicBlock and projection-block forward (``basic_fwd``,
``proj_fwd`` on the pipelined GEMM core of ``csrc/conv_gemm_sm90.cuh``,
with its statistics epilogue), held on the CPU through a test-local model
of its schedule.

The model runs the forward in the kernel's order and storage dtypes:
- ``y1 = conv3x3/s(x, k1)``, ``y2 = conv3x3(a1, k2)`` and (projection)
  ``yS = conv1x1/s(x, ks)`` kept in fp32 (float64 in the float64 run),
  each with the statistics epilogue's 128-row tile partials and
  ``bn_finalize_kernel``'s fp64 combine (the Bottleneck forward's model,
  ``test_torch_port_bot_fwd.py``), folded by the one ``fold`` that the
  forward's finalize and the backward's ``bn_fold_kernel`` share;
- ``a1 = rnd(relu(y1 * s1 + t1))`` stored in the compute dtype, walking
  the flat tensor four elements at a time with the channel counted along,
  as ``bn_act_kernel`` does;
- the last pass ``out = rnd(relu(y2 * s2 + t2 + (yS * sS + tS | x)))``
  at the width the host picks, as ``bot_out_kernel`` does: W = 4
  consecutive elements a thread where C % 4 == 0, else W = 1.

It is held against ``_block_fwd_reference`` in float64 to 1e-12 (the
algebra); in fp32 and bf16 against the plain form of the same dtype
within the pins of ``PERF.md`` section 2 (fp32: values rtol/atol 3e-5,
moments rtol 3e-5 / atol 2.5e-6; bf16: the round-19 pins against both
plain forms and relative L2 against the bf16 one, values 1.5e-3, moments
4e-5, the bounds ``chip_smoke.py`` holds the kernels to); and against the
JAX package's ``fused_basic_block`` / ``fused_projection_block`` forward
in interpret mode (``out`` and every moment) at the fp32 pins. Its staged
``a1`` is bitwise ``_rnd(relu(y1 * s1 + t1), cdt)`` from the same ``y1``,
and bitwise the ``a1`` that the backward's model
(``test_torch_port_block_bwd.py``) recomputes from the saved moments: the
forward and the backward form it from one plan, one K order and one fmaf.

Geometries: an identity block, a stride-1 and a stride-2 projection, the
ragged shapes ``chip_smoke.py`` runs on the card (``RAGGED_BLOCKS``:
channel counts no multiple of 4, a 72-wide output past one 64-channel
tile, a 3x3/s2 over 6 input channels, 378, 360, 315, 75 and 48 rows), and
an identity block of 189 rows (two tiles, the second of 61 rows). Inputs
are numpy draws from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_port_block_bwd as block_bwd
import test_torch_port_bot_fwd as bot_fwd
from simclr_pytorch_distributed_tpu.ops import pallas_conv
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
from torch_threads import limit_threads

limit_threads()

EPS = 1e-5

# (n, h, w, cin, c, stride): identity, stride-1 projection, stride-2
# projection, the ragged shapes chip_smoke.py runs on the card, and an
# identity block whose 189 rows leave a 61-row last tile
GEOMETRIES = [
    (2, 8, 8, 16, 16, 1),
    (2, 8, 8, 8, 16, 1),
    (2, 8, 8, 8, 16, 2),
] + [geo for _, geo in chip_smoke.RAGGED_BLOCKS] + [
    (3, 9, 7, 8, 8, 1),
]

VAL_RTOL, VAL_ATOL = chip_smoke.VAL_RTOL, chip_smoke.VAL_ATOL
STAT_RTOL, STAT_ATOL = chip_smoke.STAT_RTOL, chip_smoke.STAT_ATOL
NAMES = chip_smoke.BLOCK_OUT


# ---------------------------------------------------------------------------
# The model of the kernel's schedule
# ---------------------------------------------------------------------------


def last_pass_width(c):
    """The width the host gives ``bot_out_kernel`` (``residual_out``): four
    elements a thread where ``c % 4 == 0``, else one."""
    return 4 if c % 4 == 0 else 1


def last_pass_channels(total, c, width):
    """The channel ``bot_out_kernel`` reads for each element of a flat
    ``[rows, c]`` tensor: a thread takes the ``width`` elements from ``i``
    (a multiple of ``width``) and gives element ``e`` the channel ``i % c +
    e``, with no wrap."""
    i = torch.arange(total)
    return (i - i % width) % c + i % width


def conv_bn(src, k, stride, gamma, beta, eps):
    """One conv through the statistics epilogue and ``finalize``: ``(y,
    mean, var, scale, shift)``, the moments from the tile partials'
    fp64 combine, the fold ``fc._fold`` (the kernel's ``fold``, which the
    backward's ``bn_fold_kernel`` runs on the saved moments too)."""
    y = fc._conv(src, k, stride)
    pm, pq = bot_fwd.tile_partials(y)
    mean, var, _, _ = bot_fwd.finalize(pm, pq, y.numel() // y.shape[-1], gamma, beta, eps)
    _, scale, shift = fc._fold(mean, var, gamma, beta, eps)
    return y, mean, var, scale, shift


def schedule_model(x, k1, g1, b1, k2, g2, b2, short, stride, eps):
    """The forward in the kernel's order and storage dtypes. Returns the
    outputs in ``_block_fwd_reference``'s order and the staged tensors
    ``{"y1", "s1", "t1", "a1"}`` (``a1`` as stored, in the compute
    dtype)."""
    cdt = x.dtype
    store = (lambda t: t.to(cdt)) if cdt == torch.bfloat16 else (lambda t: t)
    xw, k1, k2 = fc._wide(x), fc._wide(k1), fc._wide(k2)
    y1, m1, v1, s1, t1 = conv_bn(xw, k1, stride, g1, b1, eps)
    a1 = bot_fwd.activate(y1, s1, t1, store)
    y2, m2, v2, s2, t2 = conv_bn(fc._wide(a1), k2, 1, g2, b2, eps)
    moments = (m1, v1, m2, v2)
    if short is None:
        sc = xw
    else:
        ks, gs, bs = short
        ys, ms, vs, ss, ts = conv_bn(xw, fc._wide(ks), stride, gs, bs, eps)
        moments += (ms, vs)
    c = y2.shape[-1]
    ch = last_pass_channels(y2.numel(), c, last_pass_width(c))
    flat = y2.reshape(-1)
    z = flat * s2[ch] + t2[ch]
    z = z + (sc.reshape(-1) if short is None else ys.reshape(-1) * ss[ch] + ts[ch])
    out = torch.relu(z).reshape(y2.shape)
    staged = {"y1": y1, "s1": s1, "t1": t1, "a1": a1}
    return (out.to(cdt),) + moments, staged


def _inputs(n, h, w, cin, c, stride, dtype, seed=31):
    """The block's arguments in ``_block_fwd_reference`` order in compute
    dtype ``dtype`` (float64, fp32 or bf16; the BN rows stay fp32 but for
    float64)."""
    rng = np.random.default_rng(seed)
    rand = lambda shape, scale=1.0, shift=0.0: block_bwd._rand(rng, shape, scale, shift)  # noqa: E731
    proj = stride != 1 or cin != c
    x = rand((n, h, w, cin))
    k1 = rand((3, 3, cin, c), (9 * cin) ** -0.5)
    k2 = rand((3, 3, c, c), (9 * c) ** -0.5)
    bn = [(rand((c,), 0.2, 1.0), rand((c,), 0.1)) for _ in range(3)]
    ks = rand((cin, c), cin ** -0.5) if proj else None
    if dtype != torch.float64:
        x, k1, k2 = (t.float().to(dtype) for t in (x, k1, k2))
        bn = [(g.float(), b.float()) for g, b in bn]
        ks = ks.float().to(dtype) if proj else None
    (g1, b1), (g2, b2), (gs, bs) = bn
    short = (ks, gs, bs) if proj else None
    return (x, k1, g1, b1, k2, g2, b2, short, stride, EPS)


# ---------------------------------------------------------------------------
# The last pass's width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 3, 4, 5, 6, 10, 12, 20, 40, 72])
def test_last_pass_width_reads_each_elements_own_channel(c):
    """At the host's width every element of a flat ``[rows, C]`` tensor
    reads its own channel. Four elements a thread at a C that is no
    multiple of 4 would run a group across a row's end and read channels
    past C, which is why such C take one element a thread."""
    for rows in range(1, 13):
        total = rows * c
        width = last_pass_width(c)
        assert total % width == 0
        assert torch.equal(last_pass_channels(total, c, width), torch.arange(total) % c)
    if c % 4:  # the group around the first row's end reads past C
        assert last_pass_channels(4 * c, c, 4).max().item() >= c


# ---------------------------------------------------------------------------
# The schedule against the plain forms and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_matches_reference_in_float64(geo):
    args = _inputs(*geo, torch.float64)
    got, _ = schedule_model(*args)
    ref = fc._block_fwd_reference(*args)
    assert len(got) == len(ref) == (7 if args[7] is not None else 5)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
        assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_meets_the_fp32_pins(geo):
    args = _inputs(*geo, torch.float32)
    got, _ = schedule_model(*args)
    ref = fc._block_fwd_reference(*args)
    for name, a, b in zip(NAMES, got, ref):
        assert a.dtype == b.dtype == torch.float32
        rtol, atol = (VAL_RTOL, VAL_ATOL) if name == "out" else (STAT_RTOL, STAT_ATOL)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_meets_the_bf16_pins(geo):
    args = _inputs(*geo, torch.bfloat16)
    got, _ = schedule_model(*args)
    r16 = fc._block_fwd_reference(*args)
    x, k1, g1, b1, k2, g2, b2, short = args[:8]
    wide = lambda t: t.float()  # noqa: E731
    short32 = None if short is None else (wide(short[0]),) + short[1:]
    r32 = fc._block_fwd_reference(wide(x), wide(k1), g1, b1, wide(k2), g2, b2, short32,
                                  *args[8:])
    for name, a, b, c in zip(NAMES, got, r16, r32):
        kind = "value" if name == "out" else "stats"
        assert a.dtype == b.dtype
        assert chip_smoke.rel_l2(a, b) <= chip_smoke.BF16_REL_L2[kind], name
        for ref in (b, c):
            scaled, cos = chip_smoke.bf16_measure(a, ref)
            assert chip_smoke.bf16_ok(kind, scaled, cos), (name, scaled, cos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_staged_a1_is_the_plain_forms_rounded_value(geo, dtype):
    """``a1`` is stored in the compute dtype and equals bitwise what the
    plain form passes to the second conv, ``_rnd(relu(y1 * s1 + t1),
    cdt)``, from the same ``y1`` and the same folded BN."""
    args = _inputs(*geo, dtype)
    _, staged = schedule_model(*args)
    a1, y1, s1, t1 = staged["a1"], staged["y1"], staged["s1"], staged["t1"]
    assert a1.dtype == dtype and y1.dtype == torch.float32
    assert torch.equal(fc._wide(a1), fc._rnd(torch.relu(y1 * s1 + t1), dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_forward_a1_is_the_backwards_recomputed_a1(geo, dtype):
    """The backward recomputes ``y1`` on the forward's plan and forms ``a1``
    from the saved moments with the same fold and fmaf, so the forward's
    staged ``a1`` equals the backward model's bitwise."""
    args = _inputs(*geo, dtype)
    x, k1, g1, b1, k2, g2, b2, short, stride, eps = args
    outs, staged = schedule_model(*args)
    moments = outs[1:]
    short_b = None if short is None else short + tuple(moments[4:6])
    rng = np.random.default_rng(5)
    gout = torch.from_numpy(rng.standard_normal(tuple(outs[0].shape)).astype(np.float32))
    _, bwd_staged = block_bwd.schedule_model(x, k1, g1, b1, k2, g2, b2, short_b, *moments[:4],
                                             gout.to(dtype), stride, eps)
    assert bwd_staged["a1"].dtype == staged["a1"].dtype == dtype
    assert torch.equal(bwd_staged["a1"], staged["a1"])


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_matches_the_pallas_forward(geo):
    """The model in fp32 against ``pallas_conv.fused_basic_block`` /
    ``fused_projection_block`` in interpret mode: ``out`` at rtol/atol
    3e-5, every moment at rtol 3e-5 / atol 2.5e-6 (the fp32 pins)."""
    n, h, w, cin, c, stride = geo
    args = _inputs(*geo, torch.float32, seed=41)
    x, k1, g1, b1, k2, g2, b2, short = args[:8]
    assert pallas_conv.supports_block(n, h, w, c, stride=stride, in_channels=cin)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    block = (j(t) for t in (x, k1, g1, b1, k2, g2, b2))
    if short is None:
        res_j = pallas_conv.fused_basic_block(*block, eps=EPS, interpret=True)
    else:
        res_j = pallas_conv.fused_projection_block(*block, *(j(t) for t in short),
                                                   stride=stride, eps=EPS, interpret=True)
    got, _ = schedule_model(*args)
    assert len(got) == len(res_j)
    for name, a, b in zip(NAMES, got, res_j):
        rtol, atol = (VAL_RTOL, VAL_ATOL) if name == "out" else (STAT_RTOL, STAT_ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol, err_msg=name)
