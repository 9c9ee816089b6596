"""The redesigned Bottleneck forward (``bottleneck_fwd`` on the pipelined GEMM
core of ``csrc/conv_gemm_sm90.cuh``, with its statistics epilogue), held on
the CPU through a test-local model of its schedule.

The model runs the forward in the kernel's order and storage dtypes:
- each conv's pre-BN ``y`` kept in fp32 (float64 in the float64 run), with
  the statistics epilogue's per-tile partials: for each 128-row tile of the
  GEMM rows (the last one ragged), the tile mean and the sum of squares
  about it;
- ``bn_finalize_kernel``'s combine of those partials in fp64 around the
  first tile's mean, then the fold into scale and shift;
- the activate pass ``a = rnd(relu(y * scale + shift))`` stored in the
  compute dtype, walking the flat tensor four elements at a time with the
  channel counted along, as ``bn_act_kernel`` does;
- the 4-wide last pass ``out = rnd(relu(y3 * s3 + t3 + (yS * sS + tS |
  x)))``, as ``bot_out_kernel`` does.

It is held three ways:
- against ``bottleneck_fwd_reference`` in float64, to 1e-12 (the algebra);
- in fp32 and bf16 against the plain form of the same dtype within the
  pins of ``PERF.md`` section 2 (fp32: values rtol/atol 3e-5, moments rtol
  3e-5 / atol 2.5e-6; bf16: the round-19 pins against both plain forms and
  relative L2 against the bf16 one, values 1.5e-3, moments 4e-5, the bounds
  ``chip_smoke.py`` holds the kernels to), with its staged ``a1``/``a2``
  stored in the compute dtype and bitwise equal to the plain form's
  ``_rnd(relu(y * s + t), cdt)`` from the same ``y``;
- against the JAX package's ``fused_bottleneck_block`` forward run in
  interpret mode, as ``tests/test_pallas_conv.py`` runs it: ``out`` and
  every moment, for identity and projection blocks at stride 1 and 2, at
  the fp32 pins above.

Geometries: those of ``test_torch_port_bot_bwd.py`` plus one identity block
of 189 rows (two tiles, the second of 61 rows). Inputs are numpy draws from
fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simclr_pytorch_distributed_tpu.ops import pallas_conv
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc

EPS = 1e-5
TILE = 128  # rows of a statistics tile (sm90::GEMM_BM)

# identity, stride-1 projection, stride-2 projection, the ragged shapes
# chip_smoke.py runs on the card (P = 10 identity, P = 40 at s2; 360 and 90
# rows), and an identity block whose 189 rows leave a 61-row last tile
GEOMETRIES = [
    (2, 8, 8, 16, 4, 1),
    (2, 8, 8, 8, 4, 1),
    (2, 8, 8, 16, 8, 2),
    (6, 10, 6, 40, 10, 1),
    (6, 10, 6, 24, 40, 2),
    (3, 9, 7, 16, 4, 1),
]

VAL_RTOL, VAL_ATOL = chip_smoke.VAL_RTOL, chip_smoke.VAL_ATOL
STAT_RTOL, STAT_ATOL = chip_smoke.STAT_RTOL, chip_smoke.STAT_ATOL
NAMES = ("out", "m1", "v1", "m2", "v2", "m3", "v3", "m_sc", "v_sc")


# ---------------------------------------------------------------------------
# The model of the kernel's schedule
# ---------------------------------------------------------------------------


def tile_partials(y):
    """The statistics epilogue: ``(part_mean, part_m2)``, ``[tiles, C]``,
    per 128-row tile of ``y``'s rows (NHWC flattened to ``[rows, C]``), the
    mean over the tile's rows and the sum of squares about it, in ``y``'s
    dtype."""
    rows = y.reshape(-1, y.shape[-1])
    means, m2s = [], []
    for t0 in range(0, rows.shape[0], TILE):
        tile = rows[t0:t0 + TILE]
        mu = tile.sum(dim=0) / tile.shape[0]
        means.append(mu)
        m2s.append(((tile - mu) ** 2).sum(dim=0))
    return torch.stack(means), torch.stack(m2s)


def finalize(part_mean, part_m2, rows, gamma, beta, eps):
    """``bn_finalize_kernel``: the partials combined in fp64 around the first
    tile's mean K (``sum (y - K) = sum_t n_t (mean_t - K)``, ``sum (y - K)^2
    = sum_t [m2_t + n_t (mean_t - K)^2]``), the moments rounded to the
    partials' dtype, then folded: ``(mean, var, scale, shift)``."""
    k = part_mean[0].double()
    counts = torch.tensor([min(TILE, rows - t * TILE) for t in range(part_mean.shape[0])],
                          dtype=torch.float64)[:, None]
    d = part_mean.double() - k
    mu = (counts * d).sum(dim=0) / rows
    var = ((part_m2.double() + counts * d * d).sum(dim=0) / rows - mu * mu).clamp_min(0.0)
    mean, var = (k + mu).to(part_mean.dtype), var.to(part_mean.dtype)
    scale = gamma * (1.0 / torch.sqrt(var + eps))
    return mean, var, scale, beta - mean * scale


def flat_channels(total, c):
    """The channel of each element of a flat ``[rows, c]`` tensor as the
    4-wide passes count it: a thread takes the group of four at ``i`` (a
    multiple of 4), starts at ``i % c`` and steps the channel by one per
    element, wrapping at ``c``."""
    i = torch.arange(total)
    ch = (i - i % 4) % c
    for e in range(1, 4):  # the element e of its group takes e steps
        ch = ch + (i % 4 >= e).long()
        ch = torch.where(ch == c, torch.zeros_like(ch), ch)
    return ch


def activate(y, scale, shift, store):
    """``bn_act_kernel``: ``a = rnd(relu(y * scale + shift))`` over the flat
    tensor, stored by ``store`` (the compute dtype)."""
    flat = y.reshape(-1)
    ch = flat_channels(flat.numel(), y.shape[-1])
    return store(torch.relu(flat * scale[ch] + shift[ch])).reshape(y.shape)


def schedule_model(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, eps):
    """The forward in the kernel's order and storage dtypes. Returns the
    outputs in ``bottleneck_fwd_reference``'s order and the staged tensors
    ``{"y1", "s1", "t1", "a1", "y2", "s2", "t2", "a2"}`` (``a`` as stored,
    in the compute dtype)."""
    cdt = x.dtype
    store = (lambda t: t.to(cdt)) if cdt == torch.bfloat16 else (lambda t: t)
    xw, k1, k2, k3 = (fc._wide(t) for t in (x, k1, k2, k3))

    def conv_bn(src, k, s, gamma, beta):
        y = fc._conv(src, k, s)
        pm, pq = tile_partials(y)
        return (y,) + finalize(pm, pq, y.numel() // y.shape[-1], gamma, beta, eps)

    y1, m1, v1, s1, t1 = conv_bn(xw, k1, 1, g1, b1)
    a1 = activate(y1, s1, t1, store)
    y2, m2, v2, s2, t2 = conv_bn(fc._wide(a1), k2, stride, g2, b2)
    a2 = activate(y2, s2, t2, store)
    y3, m3, v3, s3, t3 = conv_bn(fc._wide(a2), k3, 1, g3, b3)
    staged = {"y1": y1, "s1": s1, "t1": t1, "a1": a1, "y2": y2, "s2": s2, "t2": t2, "a2": a2}
    moments = (m1, v1, m2, v2, m3, v3)
    if short is None:
        sc = xw
    else:
        ks, gs, bs = short
        ys, ms, vs, ss, ts = conv_bn(xw, fc._wide(ks), stride, gs, bs)
        sc = ys * ss + ts
        moments += (ms, vs)
    # bot_out_kernel: C = 4P, so a group of four never wraps
    flat = y3.reshape(-1)
    ch = flat_channels(flat.numel(), y3.shape[-1])
    out = torch.relu(flat * s3[ch] + t3[ch] + sc.reshape(-1)).reshape(y3.shape)
    return (out.to(cdt),) + moments, staged


def _inputs(n, h, w, cin, p, stride, dtype, seed=31):
    """The block's arguments in ``bottleneck_fwd`` order in compute dtype
    ``dtype`` (float64, fp32 or bf16; the BN rows stay fp32 but for
    float64)."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float64))

    proj = stride != 1 or cin != 4 * p
    x = draw((n, h, w, cin))
    k1, k2, k3 = draw((cin, p), cin ** -0.5), draw((3, 3, p, p), (9 * p) ** -0.5), draw(
        (p, 4 * p), p ** -0.5)
    bn = [(draw((c,), 0.2, 1.0), draw((c,), 0.1)) for c in (p, p, 4 * p)]
    short = (draw((cin, 4 * p), cin ** -0.5), draw((4 * p,), 0.2, 1.0),
             draw((4 * p,), 0.1)) if proj else None
    if dtype != torch.float64:
        x, k1, k2, k3 = (t.float().to(dtype) for t in (x, k1, k2, k3))
        bn = [(g.float(), b.float()) for g, b in bn]
        if short is not None:
            short = (short[0].float().to(dtype), short[1].float(), short[2].float())
    (g1, b1), (g2, b2), (g3, b3) = bn
    return (x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, EPS)


# ---------------------------------------------------------------------------
# The model's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 127, 128, 129, 300, 512])
def test_tile_partials_and_finalize_give_the_batch_moments(rows):
    """In float64 the partials and their combine give ``torch.var_mean``'s
    moments, whatever the last tile's height; shifted data (mean far from
    zero) loses nothing to cancellation."""
    rng = np.random.default_rng(rows)
    y = torch.from_numpy(rng.standard_normal((rows, 7)) * 3.0 + 50.0)
    pm, pq = tile_partials(y)
    assert pm.shape == (-(-rows // TILE), 7)
    ones, zeros = torch.ones(7, dtype=torch.float64), torch.zeros(7, dtype=torch.float64)
    mean, var, scale, shift = finalize(pm, pq, rows, ones, zeros, EPS)
    ref_var, ref_mean = torch.var_mean(y, dim=0, correction=0)
    assert torch.allclose(mean, ref_mean, rtol=1e-13, atol=0)
    assert torch.allclose(var, ref_var, rtol=1e-11, atol=1e-13)
    assert torch.allclose(scale * ref_mean + shift, zeros, atol=1e-11)


@pytest.mark.parametrize("c", [1, 3, 4, 5, 10, 40, 64])
def test_flat_channel_walk_is_the_channel_layout(c):
    """The 4-wide passes' channel walk (start at ``i % C``, step and wrap)
    gives each element of a flat ``[rows, C]`` tensor its own channel, the
    last group of four partial or whole."""
    for rows in range(1, 13):
        assert torch.equal(flat_channels(rows * c, c), torch.arange(rows * c) % c)


# ---------------------------------------------------------------------------
# The schedule against the plain forms and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_matches_reference_in_float64(geo):
    args = _inputs(*geo, torch.float64)
    got, _ = schedule_model(*args)
    ref = fc.bottleneck_fwd_reference(*args)
    assert len(got) == len(ref) == (9 if args[10] is not None else 7)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
        assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_meets_the_fp32_pins(geo):
    args = _inputs(*geo, torch.float32)
    got, _ = schedule_model(*args)
    ref = fc.bottleneck_fwd_reference(*args)
    for name, a, b in zip(NAMES, got, ref):
        assert a.dtype == b.dtype == torch.float32
        rtol, atol = (VAL_RTOL, VAL_ATOL) if name == "out" else (STAT_RTOL, STAT_ATOL)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_meets_the_bf16_pins(geo):
    args = _inputs(*geo, torch.bfloat16)
    got, _ = schedule_model(*args)
    r16 = fc.bottleneck_fwd_reference(*args)
    x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short = args[:11]
    wide = lambda t: t.float()  # noqa: E731
    short32 = None if short is None else (wide(short[0]),) + short[1:]
    r32 = fc.bottleneck_fwd_reference(wide(x), wide(k1), g1, b1, wide(k2), g2, b2, wide(k3), g3,
                                      b3, short32, *args[11:])
    for name, a, b, c in zip(NAMES, got, r16, r32):
        kind = "value" if name == "out" else "stats"
        assert a.dtype == b.dtype
        assert chip_smoke.rel_l2(a, b) <= chip_smoke.BF16_REL_L2[kind], name
        for ref in (b, c):
            scaled, cos = chip_smoke.bf16_measure(a, ref)
            assert chip_smoke.bf16_ok(kind, scaled, cos), (name, scaled, cos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_staged_operands_are_the_plain_forms_rounded_values(geo, dtype):
    """``a1``/``a2`` are stored in the compute dtype, and equal bitwise what
    the plain form passes to the next conv, ``_rnd(relu(y * s + t), cdt)``,
    from the same ``y`` and the same folded BN."""
    args = _inputs(*geo, dtype)
    _, staged = schedule_model(*args)
    for k in ("1", "2"):
        a = staged["a" + k]
        assert a.dtype == dtype
        y, s, t = staged["y" + k], staged["s" + k], staged["t" + k]
        assert y.dtype == torch.float32
        assert torch.equal(fc._wide(a), fc._rnd(torch.relu(y * s + t), dtype))


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_model_matches_the_pallas_forward(geo):
    """The model in fp32 against ``pallas_conv.fused_bottleneck_block`` in
    interpret mode: ``out`` at rtol/atol 3e-5, every moment at rtol 3e-5 /
    atol 2.5e-6 (the fp32 pins)."""
    n, h, w, cin, p, stride = geo
    args = _inputs(*geo, torch.float32, seed=41)
    x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short = args[:11]
    assert pallas_conv.supports_bottleneck(n, h, w, p, stride=stride, in_channels=cin)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    res_j = pallas_conv.fused_bottleneck_block(
        *(j(t) for t in (x, k1, g1, b1, k2, g2, b2, k3, g3, b3)),
        None if short is None else tuple(j(t) for t in short),
        stride=stride, eps=EPS, interpret=True)
    got, _ = schedule_model(*args)
    assert len(got) == len(res_j)
    for name, a, b in zip(NAMES, got, res_j):
        rtol, atol = (VAL_RTOL, VAL_ATOL) if name == "out" else (STAT_RTOL, STAT_ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol, err_msg=name)
