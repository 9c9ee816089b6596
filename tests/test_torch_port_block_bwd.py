"""The redesigned BasicBlock and projection-block backward (``basic_bwd``,
``proj_bwd`` on the pipelined GEMM core of ``csrc/conv_gemm_sm90.cuh``),
held on the CPU through a model of its schedule.

- The whole schedule: a test-local model that runs the backward in the
  kernel's order and storage dtypes (the recomputed ``a1 = rnd(relu(y1 *
  scale + shift))`` staged in the compute dtype, stage 2 in two passes with
  ``dz`` and the cotangents ``dy2``, ``dyS`` and ``dy1`` stored in the
  compute dtype, the stride-2 ``dx`` by parity class with the shortcut's
  share added in the even-even class alone) against
  ``fused_conv._block_bwd_reference``: in float64 to 1e-12 (the algebra),
  in bf16 within the relative-L2 and round-19 pins ``chip_smoke.py`` holds
  the bf16 kernels to against the bf16 plain form, and with its staged
  ``a1`` and ``dz`` bitwise equal to the values the plain forms round at
  the same points. So the redesign moves no rounding point. The shapes are
  an identity block, a stride-1 and a stride-2 projection, and the ragged
  shapes ``chip_smoke.py`` runs on the card (channel counts no multiple of
  4, which the two passes take one channel a thread).
- The residual of the stride-2 ``dx``: the shortcut's share is written at
  the even-even pixels only and the rest of its buffer is never written
  (``torch.empty``), so the transposed 3x3/s2 adds it in parity class
  (0, 0) alone (``transposed3_plan``'s ``even_even_residual``). The model
  fills the unwritten pixels with NaN: its ``dx`` is finite, and adding
  the residual in every class would read them.
- The stride-2 ``dx`` of the model equals the JAX package's data gradient
  (``jax.vjp`` of the strided 3x3 and 1x1 convs the Pallas backward
  transposes) in fp32 at rtol 1e-5, with an absolute floor of 1e-5 x max
  |dx| for entries that cancel to zero.
- ``supports_block`` still admits every recipe and ragged geometry.

Inputs are numpy draws from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
from torch_threads import limit_threads

limit_threads()

EPS = 1e-5

# (n, h, w, cin, c, stride): identity, stride-1 projection, stride-2
# projection, then the ragged shapes chip_smoke.py runs on the card
SCHEDULE_GEOMETRIES = [
    (2, 8, 8, 16, 16, 1),
    (2, 8, 8, 8, 16, 1),
    (2, 8, 8, 8, 16, 2),
] + [geo for _, geo in chip_smoke.RAGGED_BLOCKS]

# stride-2 projections for the data gradient against JAX: rn18's layer2
# block0 at 2 rows and a sixteenth of its channels, and the ragged ones
STRIDE2_GEOMETRIES = [(2, 32, 32, 4, 8, 2)] + [
    geo for _, geo in chip_smoke.RAGGED_BLOCKS if geo[5] == 2]


def _rand(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float64))


# ---------------------------------------------------------------------------
# The data gradients by parity class
# ---------------------------------------------------------------------------


def parity_classes(stride):
    """``[(ph, pw, [(kh, kw, dh, dw), ...])]`` of ``transposed3_plan``: input
    pixel (s i + ph, s j + pw) takes dy[i + dh, j + dw] through tap (kh, kw)."""
    if stride == 1:
        return [(0, 0, [(kh, kw, 1 - kh, 1 - kw) for kh in range(3) for kw in range(3)])]
    return [(ph, pw, [(kh, kw, (ph + 1 - kh) // 2, (pw + 1 - kw) // 2)
                      for kh in range(3) if (ph + 1 - kh) % 2 == 0
                      for kw in range(3) if (pw + 1 - kw) % 2 == 0])
            for ph in range(2) for pw in range(2)]


def _shift(v, dh, dw):
    """``out[:, i, j] = v[:, i + dh, j + dw]``, zero outside ``v``."""
    n, h, w, c = v.shape
    out = v.new_zeros((n, h, w, c))
    i0, i1 = max(0, -dh), min(h, h - dh)
    j0, j1 = max(0, -dw), min(w, w - dw)
    if i0 < i1 and j0 < j1:
        out[:, i0:i1, j0:j1] = v[:, i0 + dh:i1 + dh, j0 + dw:j1 + dw]
    return out


def dx3_by_parity(dy, k, stride, h, w, res=None, even_even_residual=False):
    """The data gradient of the 3x3 pad-1 conv (HWIO ``k``) of stride
    ``stride`` as the kernel's plan runs it: one GEMM per parity class over
    its own taps with the channel-swapped weights, written to the class's
    strided pixels, plus ``res`` at those pixels in every class, or with
    ``even_even_residual`` in class (0, 0) alone."""
    kt = k.permute(0, 1, 3, 2)
    out = dy.new_zeros((dy.shape[0], h, w, k.shape[2]))
    for ph, pw, taps in parity_classes(stride):
        acc = sum(_shift(dy, dh, dw) @ kt[kh, kw] for kh, kw, dh, dw in taps)
        if res is not None and (not even_even_residual or (ph, pw) == (0, 0)):
            acc = acc + res[:, ph::stride, pw::stride]
        out[:, ph::stride, pw::stride] = acc
    return out


def shortcut_share(dys, ks, stride, h, w):
    """``shortcut_dx_plan``'s output buffer: ``dyS ks^T`` at the pixels
    (s i, s j), and NaN, for the ``torch.empty`` it lands in, elsewhere."""
    out = dys.new_full((dys.shape[0], h, w, ks.shape[0]), float("nan"))
    out[:, ::stride, ::stride] = dys @ ks.T
    return out


# ---------------------------------------------------------------------------
# The schedule of the kernel
# ---------------------------------------------------------------------------


def schedule_model(x, k1, g1, b1, k2, g2, b2, short, m1, v1, m2, v2, gout, stride, eps):
    """The backward in the kernel's order and storage dtypes. Returns the
    gradients in ``_block_bwd_reference``'s order and the staged tensors
    ``{"a1", "dz"}`` as stored (compute dtype)."""
    cdt = x.dtype
    n, hi, wi, _ = x.shape
    ho, wo = hi // stride, wi // stride
    count = n * ho * wo
    xw, k1, k2 = fc._wide(x), fc._wide(k1), fc._wide(k2)
    store = (lambda t: t.to(cdt)) if cdt == torch.bfloat16 else (lambda t: t)
    rs1, sc1, sh1 = fc._fold(m1, v1, g1, b1, eps)
    rs2, sc2, sh2 = fc._fold(m2, v2, g2, b2, eps)
    # the recomputed forward: y in fp32, a1 in the compute dtype
    y1 = fc._conv(xw, k1, stride)
    a1 = store(torch.relu(y1 * sc1 + sh1))
    y2 = fc._conv(fc._wide(a1), k2)
    if short is not None:
        ks, gs, bs, ms, vs = short
        ks = fc._wide(ks)
        rss, scs, shs = fc._fold(ms, vs, gs, bs, eps)
        ys = fc._conv(xw, ks, stride)
    # stage 2, pass 1: z in registers, dz stored, the sums
    z = y2 * sc2 + sh2 + (ys * scs + shs if short is not None else xw)
    dz = store(fc._wide(gout) * (torch.relu(z) > 0))
    dzw = fc._wide(dz)
    yh2 = (y2 - m2) * rs2
    db2, dg2 = dzw.sum(dim=(0, 1, 2)), (dzw * yh2).sum(dim=(0, 1, 2))
    # pass 2: the cotangents in the compute dtype
    dy2 = store(rs2 * g2 * (dzw - db2 / count - yh2 * dg2 / count))
    dk2 = fc._conv_dw(fc._wide(a1), fc._wide(dy2), k2.shape, 1)
    if short is not None:
        yhs = (ys - ms) * rss
        dgs = (dzw * yhs).sum(dim=(0, 1, 2))
        dys = store(rss * gs * (dzw - db2 / count - yhs * dgs / count))
        dks = fc._conv_dw(xw, fc._wide(dys), ks.shape, stride)
    # stage 1: da1 = the transposed 3x3 of dy2, its BN backward
    da1 = dx3_by_parity(fc._wide(dy2), k2, 1, ho, wo)
    dp1 = da1 * ((y1 - m1) * rs1 * g1 + b1 > 0)
    dy1, dg1, db1 = fc._bn_bwd(dp1, (y1 - m1) * rs1, rs1, g1, count)
    dy1 = store(dy1)
    dk1 = fc._conv_dw(xw, fc._wide(dy1), k1.shape, stride)
    staged = {"a1": a1, "dz": dz}
    if short is None:
        dx = dx3_by_parity(fc._wide(dy1), k1, 1, hi, wi, res=dzw)
        return (dx.to(cdt), dk1.to(cdt), dk2.to(cdt), dg1, db1, dg2, db2), staged
    # dx: the shortcut's share first, then the transposed 3x3/s adding it
    dxs = shortcut_share(fc._wide(dys), ks, stride, hi, wi)
    dx = dx3_by_parity(fc._wide(dy1), k1, stride, hi, wi, res=dxs, even_even_residual=True)
    return ((dx.to(cdt), dk1.to(cdt), dk2.to(cdt), dks.to(cdt), dg1, db1, dg2, db2, dgs, db2),
            staged)


def _schedule_inputs(n, h, w, cin, c, stride, dtype, seed=31):
    """The block's arguments in ``_block_bwd_reference`` order (moments from
    the plain forward, ``gout`` a draw) in compute dtype ``dtype``."""
    rng = np.random.default_rng(seed)
    proj = stride != 1 or cin != c
    x = _rand(rng, (n, h, w, cin))
    k1 = _rand(rng, (3, 3, cin, c), (9 * cin) ** -0.5)
    k2 = _rand(rng, (3, 3, c, c), (9 * c) ** -0.5)
    bn = [(_rand(rng, (c,), 0.2, 1.0), _rand(rng, (c,), 0.1)) for _ in range(3)]
    ks = _rand(rng, (cin, c), cin ** -0.5) if proj else None
    if dtype != torch.float64:
        x, k1, k2 = (t.float().to(dtype) for t in (x, k1, k2))
        bn = [(g.float(), b.float()) for g, b in bn]
        ks = ks.float().to(dtype) if proj else None
    (g1, b1), (g2, b2), (gs, bs) = bn
    short = (ks, gs, bs) if proj else None
    fwd = fc._block_fwd_reference(x, k1, g1, b1, k2, g2, b2, short, stride, EPS)
    gout = _rand(rng, tuple(fwd[0].shape))
    gout = gout if dtype == torch.float64 else gout.float().to(dtype)
    short_b = short + tuple(fwd[5:7]) if proj else None
    return (x, k1, g1, b1, k2, g2, b2, short_b, *fwd[1:5], gout, stride, EPS)


@pytest.mark.parametrize("geo", SCHEDULE_GEOMETRIES)
def test_schedule_model_matches_reference_in_float64(geo):
    args = _schedule_inputs(*geo, torch.float64)
    got, _ = schedule_model(*args)
    ref = fc._block_bwd_reference(*args)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-12 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("geo", SCHEDULE_GEOMETRIES)
def test_schedule_model_meets_the_bf16_pins(geo):
    args = _schedule_inputs(*geo, torch.bfloat16)
    got, _ = schedule_model(*args)
    ref = fc._block_bwd_reference(*args)
    bound = chip_smoke.BF16_REL_L2["grad"]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert chip_smoke.rel_l2(a, b) <= bound
        scaled, cos = chip_smoke.bf16_measure(a, b)
        assert chip_smoke.bf16_ok("grad", scaled, cos)


@pytest.mark.parametrize("geo", SCHEDULE_GEOMETRIES)
def test_staged_operands_are_the_plain_forms_rounded_values(geo):
    """``a1`` is the forward plain form's rounded conv operand
    (``rnd(relu(y1 * s1 + t1))`` from the saved moments), and ``dz`` is the
    backward plain form's ``gout * (z > 0)``, bitwise: bf16 values where
    the plain forms round them to bf16, and ``dz`` exact."""
    args = _schedule_inputs(*geo, torch.bfloat16)
    x, k1, g1, b1, k2, g2, b2, short, m1, v1, m2, v2, gout, stride, eps = args
    _, staged = schedule_model(*args)
    cdt = torch.bfloat16
    _, s1, t1 = fc._fold(m1, v1, g1, b1, eps)
    a1 = fc._rnd(torch.relu(fc._conv(fc._wide(x), fc._wide(k1), stride) * s1 + t1), cdt)
    assert staged["a1"].dtype == cdt and staged["dz"].dtype == cdt
    assert torch.equal(staged["a1"].float(), a1)
    # dz as _block_bwd_reference forms it
    z = ((fc._conv(a1, fc._wide(k2)) - m2) * torch.rsqrt(v2 + eps)) * g2 + b2
    if short is None:
        z = z + fc._wide(x)
    else:
        ks, gs, bs, ms, vs = short
        z = z + ((fc._conv(fc._wide(x), fc._wide(ks), stride) - ms) * torch.rsqrt(vs + eps)) * gs + bs
    assert torch.equal(staged["dz"].float(), fc._wide(gout) * (z > 0))


@pytest.mark.parametrize("n,h,w,cin,c,stride", STRIDE2_GEOMETRIES)
def test_shortcut_residual_is_read_at_the_even_even_pixels_only(n, h, w, cin, c, stride):
    rng = np.random.default_rng(41)
    dy1, dys = _rand(rng, (n, h // 2, w // 2, c)), _rand(rng, (n, h // 2, w // 2, c))
    k1, ks = _rand(rng, (3, 3, cin, c), 0.3), _rand(rng, (cin, c), 0.3)
    dxs = shortcut_share(dys, ks, 2, h, w)
    assert torch.isnan(dxs).any()
    got = dx3_by_parity(dy1, k1, 2, h, w, res=dxs, even_even_residual=True)
    assert torch.isfinite(got).all()
    ref = fc._conv_dx(dy1, k1, 2, h, w) + fc._conv_dx(dys, ks, 2, h, w)
    assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
    # a residual added in every class reads the pixels the share never wrote
    assert torch.isnan(dx3_by_parity(dy1, k1, 2, h, w, res=dxs)).any()


@pytest.mark.parametrize("n,h,w,cin,c,stride", STRIDE2_GEOMETRIES)
def test_stride2_dx_equals_jax_data_gradient(n, h, w, cin, c, stride):
    rng = np.random.default_rng(42)
    ho, wo = h // 2, w // 2
    k1 = (rng.standard_normal((3, 3, cin, c)) * 0.3).astype(np.float32)
    ks = (rng.standard_normal((cin, c)) * 0.3).astype(np.float32)
    dy1 = rng.standard_normal((n, ho, wo, c)).astype(np.float32)
    dys = rng.standard_normal((n, ho, wo, c)).astype(np.float32)

    def convs(x):
        dn = ("NHWC", "HWIO", "NHWC")
        y1 = jax.lax.conv_general_dilated(x, jnp.asarray(k1), (2, 2), ((1, 1), (1, 1)),
                                          dimension_numbers=dn)
        ys = jax.lax.conv_general_dilated(x, jnp.asarray(ks.reshape(1, 1, cin, c)), (2, 2),
                                          ((0, 0), (0, 0)), dimension_numbers=dn)
        return y1, ys
    _, vjp = jax.vjp(convs, jnp.zeros((n, h, w, cin), jnp.float32))
    ref = np.asarray(vjp((jnp.asarray(dy1), jnp.asarray(dys)))[0])
    dxs = shortcut_share(torch.from_numpy(dys), torch.from_numpy(ks), 2, h, w)
    got = dx3_by_parity(torch.from_numpy(dy1), torch.from_numpy(k1), 2, h, w, res=dxs,
                        even_even_residual=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_supports_block_admits_recipe_and_ragged_geometries():
    geos = [geo for _, _, geo in chip_smoke.model_sites("resnet18")]
    geos += SCHEDULE_GEOMETRIES + STRIDE2_GEOMETRIES
    for n, h, w, cin, c, stride in geos:
        for dtype in fc.COMPUTE_DTYPES:
            assert fc.supports_block(n, h, w, c, stride=stride, in_channels=cin,
                                     dtype=dtype), (n, h, w, cin, c, stride)
