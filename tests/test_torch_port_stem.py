"""The redesigned stem (``stem_fwd`` / ``stem_bwd``: two passes over the batch
that each recompute the conv, ``csrc/fused_conv_bn.cu``, section "The
stem"), held on the CPU through a test-local model of its schedule.

The model runs the kernels' passes in their order and storage dtypes:
- the im2col rows with K packed (kh, kw, ci), the HWIO weight rows' order,
  walked in 32-deep chunks; a port of the kernel's gather (each element at
  a fixed offset from its row's pixel in the flattened ``x``, growing by one
  along K but at a new kh, masked by the taps inside the image) is held to
  that im2col element for element;
- ``y`` per 128-row tile from one function, which every pass calls, so
  forward pass 1's, pass 2's and the backward's ``y`` are one tensor;
- forward pass 1: the tile partials and ``bn_finalize_kernel``'s fp64
  combine (``test_torch_port_bot_fwd.py``'s ``tile_partials`` /
  ``finalize``); pass 2: ``out = rnd(relu(fmaf(y, scale, shift)))``;
- backward pass 1: ``dp = gout`` where ``fmaf(yh, gamma, beta) > 0``,
  per-CTA partials of ``sum dp`` and ``sum dp yh`` over a fixed tile walk
  (CTA ``c`` takes tiles ``c, c + G, ...``), combined in fp64 in order;
  pass 2: ``dy = rstd gamma (dp - dbeta / n - yh dgamma / n)`` rounded to
  the compute dtype before the weight product, per-CTA ``dk`` partials
  over the same walk, combined in fp64 and rounded once; ``dx`` the
  transposed 3x3 of that ``dy``.

It is held against ``stem_fwd_reference`` / ``stem_bwd_reference`` in
float64 to 1e-12 (the algebra), in fp32 at the pins of ``PERF.md`` section
2 (values rtol/atol 3e-5, moments rtol 3e-5 / atol 2.5e-6; gradients rtol
1e-4 / atol 1e-3, or at the recipe's shape relative L2 1e-2 against
float64), in bf16 at the round-19 pins against both plain forms and
relative L2 against the bf16 one (the bounds ``chip_smoke.py`` holds the
kernels to), and against the JAX package's ``fused_conv_bn_relu``
(``pallas_conv.py:600``) in interpret mode at the fp32 pins: value,
moments and every gradient.

Geometries (``(n, h, w, cin, cout)``): the recipe's stem cut to two images,
the ragged cases of ``chip_smoke.STEM_CASES`` ([6,10,6,3] and [5,7,9,5]->72:
K = 45 in two chunks, the first straddling a tap, a 72-wide output past one
64-channel block) and [3,9,7,3], whose 189 rows leave a 61-row last tile.
Inputs are numpy draws from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import test_torch_port_bot_fwd as bot_fwd
from simclr_pytorch_distributed_tpu.ops import pallas_conv
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
from torch_threads import limit_threads

limit_threads()

EPS = 1e-5
TILE = bot_fwd.TILE  # rows of a tile (BM)
KC = 32  # K chunk

GEOMETRIES = [(2, 32, 32, 3, 64)] + [
    geo for _, geo, _, _ in chip_smoke.STEM_CASES if geo[0] != 512] + [(3, 9, 7, 3, 64)]

VAL_RTOL, VAL_ATOL = chip_smoke.VAL_RTOL, chip_smoke.VAL_ATOL
STAT_RTOL, STAT_ATOL = chip_smoke.STAT_RTOL, chip_smoke.STAT_ATOL
GRAD_RTOL, GRAD_ATOL = chip_smoke.GRAD_RTOL, chip_smoke.GRAD_ATOL
NAMES = ("out", "mean", "var")
GRADS = ("dx", "dk", "dgamma", "dbeta")


# ---------------------------------------------------------------------------
# The model of the kernels' schedule
# ---------------------------------------------------------------------------


def im2col(x):
    """``[n h w, 9 cin]``: row ``(b, i, j)``, column ``(kh 3 + kw) cin + ci``
    holds ``x[b, i + kh - 1, j + kw - 1, ci]`` (zero padding), so that
    ``im2col(x) @ k.reshape(9 cin, cout)`` is the conv."""
    n, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, kh:kh + h, kw:kw + w, :] for kh in range(3) for kw in range(3)]
    return torch.cat(taps, dim=-1).reshape(n * h * w, 9 * cin)


def gather_model(x, m0, kc):
    """``gather_load`` of the kernel: chunk ``kc`` of tile ``m0``'s im2col
    rows as its two threads a row load it, sixteen columns each (``[TILE,
    KC]``, zero past the rows and past K)."""
    n, h, w, cin = x.shape
    rows, K = n * h * w, 9 * cin
    flat = x.reshape(-1)
    out = torch.zeros((TILE, KC), dtype=x.dtype)
    for r in range(TILE):
        m = m0 + r
        taps = 0
        if m < rows:
            q, j = divmod(m, w)
            i = q % h
            cols = (1 if j > 0 else 0) | 2 | (4 if j < w - 1 else 0)
            taps = (cols if i > 0 else 0) | (cols << 3) | ((cols << 6) if i < h - 1 else 0)
        for half in range(2):
            k = kc * KC + half * 16
            t = k // cin
            ci, kw = k - t * cin, t % 3
            off = ((t // 3 - 1) * w + kw - 1) * cin + ci
            for e in range(16):
                if t < 9 and (taps >> t) & 1:
                    out[r, half * 16 + e] = flat[m * cin + off]
                off += 1
                ci += 1
                if ci == cin:
                    ci, t, kw = 0, t + 1, kw + 1
                    if kw == 3:
                        kw, off = 0, off + (w - 3) * cin
    return out


def fmaf(a, b, c):
    """``fmaf`` elementwise: one rounding of ``a b + c`` to ``a``'s dtype
    (the fp32 product is exact in float64; the sum rounds there and again to
    fp32, which is fmaf but for rare double roundings)."""
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(a.dtype)


class Schedule:
    """The stem's passes for one call's ``x`` and ``k`` in compute dtype
    ``x.dtype`` (float64, fp32 or bf16; fp32 arithmetic on bf16 operands)."""

    def __init__(self, x, k):
        self.cdt = x.dtype
        self.n, self.h, self.w, self.cin = x.shape
        self.cout = k.shape[3]
        self.rows = self.n * self.h * self.w
        self.tiles = -(-self.rows // TILE)
        self.work = torch.float64 if self.cdt == torch.float64 else torch.float32
        self.a = im2col(fc._wide(x)).to(self.work)
        self.kmat = fc._wide(k).reshape(9 * self.cin, self.cout).to(self.work)

    def rows_of(self, t):
        return slice(t * TILE, min((t + 1) * TILE, self.rows))

    def y_tile(self, t):
        """``y`` of tile ``t``: every pass calls this, in one K order."""
        return self.a[self.rows_of(t)] @ self.kmat

    def walk(self, ctas):
        """The tiles of each CTA: ``c, c + ctas, ...``."""
        return [range(c, self.tiles, ctas) for c in range(ctas)]

    def forward(self, g, b, eps):
        """``(out, mean, var)`` and the ``y`` of each pass."""
        y1 = torch.cat([self.y_tile(t) for t in range(self.tiles)])
        pm, pq = bot_fwd.tile_partials(y1)
        mean, var, scale, shift = bot_fwd.finalize(pm, pq, self.rows, g, b, eps)
        y2 = torch.cat([self.y_tile(t) for t in range(self.tiles)])
        out = torch.relu(fmaf(y2, scale, shift)).to(self.cdt)
        return (out.reshape(self.n, self.h, self.w, self.cout), mean, var), (y1, y2)

    def backward(self, g, b, m, v, gout, eps, need_dx=True, ctas=3):
        """``(dx or None, dk, dgamma, dbeta)`` and the recomputed ``y``."""
        rs = 1.0 / torch.sqrt(v + eps)  # bn_fold_kernel
        go = fc._wide(gout).reshape(self.rows, self.cout).to(self.work)

        def dp_of(t):
            y = self.y_tile(t)
            yh = (y - m) * rs
            return y, yh, go[self.rows_of(t)] * (fmaf(yh, g, b) > 0)

        # pass 1: per-CTA partial sums over the walk, the fp64 combine
        parts = []
        for tiles in self.walk(ctas):
            sa = sb = torch.zeros(self.cout, dtype=self.work)
            for t in tiles:
                _, yh, dp = dp_of(t)
                sa, sb = sa + dp.sum(0), sb + (dp * yh).sum(0)
            parts.append((sa, sb))
        db = sum(p[0].double() for p in parts).to(self.work)
        dg = sum(p[1].double() for p in parts).to(self.work)
        # pass 2: dy rounded to the compute dtype, per-CTA dk partials
        count = self.rows
        ys, dys, dks = [None] * self.tiles, [None] * self.tiles, []
        for tiles in self.walk(ctas):
            dk = torch.zeros_like(self.kmat)
            for t in tiles:
                ys[t], yh, dp = dp_of(t)
                dys[t] = fc._rnd(rs * g * (dp - db / count - yh * dg / count), self.cdt)
                dk = dk + self.a[self.rows_of(t)].T @ dys[t]
            dks.append(dk)
        dk = sum(d.double() for d in dks).to(self.cdt).reshape(3, 3, self.cin, self.cout)
        dy = torch.cat(dys).reshape(self.n, self.h, self.w, self.cout)
        kw = fc._wide(self.kmat.reshape(3, 3, self.cin, self.cout))
        dx = fc._conv_dx(dy, kw, 1, self.h, self.w).to(self.cdt) if need_dx else None
        return (dx, dk, dg, db), torch.cat(ys)


def _inputs(n, h, w, cin, cout, dtype, seed=31):
    """``x, k, gamma, beta`` in compute dtype ``dtype`` (the BN rows fp32
    but for float64)."""
    rng = np.random.default_rng(seed)
    draw = lambda shape, scale=1.0, shift=0.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale + shift).astype(np.float64))
    x, k = draw((n, h, w, cin)), draw((3, 3, cin, cout), (9 * cin) ** -0.5)
    g, b = draw((cout,), 0.2, 1.0), draw((cout,), 0.1)
    if dtype != torch.float64:
        x, k, g, b = x.float().to(dtype), k.float().to(dtype), g.float(), b.float()
    return x, k, g, b


def _gout(shape, dtype, seed=5):
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return t.double() if dtype == torch.float64 else t.to(dtype)


def _run(geo, dtype, need_dx=True):
    """The model's forward and backward at ``geo``: ``(fwd, bwd, args)``."""
    x, k, g, b = _inputs(*geo, dtype)
    sched = Schedule(x, k)
    fwd, _ = sched.forward(g, b, EPS)
    gout = _gout(tuple(fwd[0].shape), dtype)
    bwd, _ = sched.backward(g, b, fwd[1], fwd[2], gout, EPS, need_dx)
    return fwd, bwd, (x, k, g, b, fwd[1], fwd[2], gout)


# ---------------------------------------------------------------------------
# The model's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_gather_walk_is_the_im2col(geo):
    """The kernel's gather (offsets from the row's pixel, the tap mask, the
    chunks that straddle taps) loads every tile's im2col element for
    element, zero past the rows and past K."""
    x, _, _, _ = _inputs(*geo, torch.float64, seed=3)
    n, h, w, cin, _ = geo
    rows, K = n * h * w, 9 * cin
    cols = F.pad(im2col(x), (0, KC * -(-K // KC) - K, 0, TILE * -(-rows // TILE) - rows))
    for m0 in range(0, rows, TILE):
        for kc in range(-(-K // KC)):
            assert torch.equal(gather_model(x, m0, kc), cols[m0:m0 + TILE, kc * KC:(kc + 1) * KC])


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_packed_k_order_is_the_hwio_rows(geo):
    """``im2col(x) @ k.reshape(9 cin, cout)``, K packed (kh, kw, ci), is the
    conv in float64."""
    x, k, _, _ = _inputs(*geo, torch.float64)
    got = (im2col(x) @ k.reshape(-1, geo[4])).reshape(*geo[:3], geo[4])
    torch.testing.assert_close(got, fc._conv(x, k), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_passes_share_one_y(geo, dtype):
    """Forward pass 1's ``y``, pass 2's and the backward's recomputed one are
    one tensor: one function forms it, in one K order."""
    x, k, g, b = _inputs(*geo, dtype)
    sched = Schedule(x, k)
    fwd, (y1, y2) = sched.forward(g, b, EPS)
    _, y3 = sched.backward(g, b, fwd[1], fwd[2], _gout(tuple(fwd[0].shape), dtype), EPS)
    assert y1.dtype == torch.float32
    assert torch.equal(y1, y2) and torch.equal(y1, y3)


@pytest.mark.parametrize("ctas", [1, 2, 5])
def test_dk_partials_over_the_walk(ctas):
    """The tile walk gives every tile to one CTA; in float64 the per-CTA
    partials' combine is the reference for any CTA count, and in fp32 it
    repeats bitwise for a fixed count."""
    geo = (3, 9, 7, 3, 64)
    x, k, g, b = _inputs(*geo, torch.float64)
    sched = Schedule(x, k)
    tiles = sorted(t for walk in sched.walk(ctas) for t in walk)
    assert tiles == list(range(sched.tiles))
    fwd, _ = sched.forward(g, b, EPS)
    gout = _gout(tuple(fwd[0].shape), torch.float64)
    got, _ = sched.backward(g, b, fwd[1], fwd[2], gout, EPS, ctas=ctas)
    ref = fc.stem_bwd_reference(x, k, g, b, fwd[1], fwd[2], gout, EPS)
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= 1e-12 * max(1.0, r.abs().max().item())
    x32, k32, g32, b32 = _inputs(*geo, torch.float32)
    s32 = Schedule(x32, k32)
    f32, _ = s32.forward(g32, b32, EPS)
    go32 = _gout(tuple(f32[0].shape), torch.float32)
    once, twice = (s32.backward(g32, b32, f32[1], f32[2], go32, EPS, ctas=ctas)[0]
                   for _ in range(2))
    assert all(torch.equal(a, c) for a, c in zip(once, twice))


# ---------------------------------------------------------------------------
# The schedule against the plain forms and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_forward_matches_reference_in_float64(geo):
    x, k, g, b = _inputs(*geo, torch.float64)
    got, _ = Schedule(x, k).forward(g, b, EPS)
    for a, r in zip(got, fc.stem_fwd_reference(x, k, g, b, EPS)):
        assert a.shape == r.shape and a.dtype == r.dtype == torch.float64
        assert (a - r).abs().max().item() <= 1e-12 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_backward_matches_reference_in_float64(geo):
    fwd, bwd, args = _run(geo, torch.float64)
    ref = fc.stem_bwd_reference(*args, EPS)
    for name, a, r in zip(GRADS, bwd, ref):
        assert a.shape == r.shape and a.dtype == r.dtype == torch.float64, name
        assert (a - r).abs().max().item() <= 1e-12 * max(1.0, r.abs().max().item()), name


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_forward_meets_the_fp32_pins(geo):
    x, k, g, b = _inputs(*geo, torch.float32)
    got, _ = Schedule(x, k).forward(g, b, EPS)
    for name, a, r in zip(NAMES, got, fc.stem_fwd_reference(x, k, g, b, EPS)):
        assert a.dtype == r.dtype == torch.float32
        rtol, atol = (VAL_RTOL, VAL_ATOL) if name == "out" else (STAT_RTOL, STAT_ATOL)
        torch.testing.assert_close(a, r, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_backward_meets_the_fp32_pins(geo):
    """Elementwise against the plain fp32 form, as ``chip_smoke.py`` holds
    the ragged cases; at the recipe's width (a cut of its shape) in relative
    L2 against float64, as it holds the recipe's."""
    fwd, bwd, args = _run(geo, torch.float32)
    plain = fc.stem_bwd_reference(*args, EPS)
    if geo[1:] == (32, 32, 3, 64):
        exact = fc.stem_bwd_reference(*(t.double() for t in args), EPS)
        for name, a, e in zip(GRADS, bwd, exact):
            assert chip_smoke.rel_l2(a, e) <= chip_smoke.GRAD_REL_L2, name
        return
    for name, a, r in zip(GRADS, bwd, plain):
        assert a.dtype == r.dtype == torch.float32
        torch.testing.assert_close(a, r, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)


def _bf16_pins(got, r16, r32, kinds):
    for a, b, c, kind in zip(got, r16, r32, kinds):
        if a is None:
            continue
        assert a.dtype == b.dtype
        assert chip_smoke.rel_l2(a, b) <= chip_smoke.BF16_REL_L2[kind], kind
        for ref in (b, c):
            scaled, cos = chip_smoke.bf16_measure(a, ref)
            assert chip_smoke.bf16_ok(kind, scaled, cos), (kind, scaled, cos)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_forward_meets_the_bf16_pins(geo):
    x, k, g, b = _inputs(*geo, torch.bfloat16)
    got, _ = Schedule(x, k).forward(g, b, EPS)
    assert got[0].dtype == torch.bfloat16
    r16 = fc.stem_fwd_reference(x, k, g, b, EPS)
    r32 = fc.stem_fwd_reference(x.float(), k.float(), g, b, EPS)
    _bf16_pins(got, r16, r32, ("value", "stats", "stats"))


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_backward_meets_the_bf16_pins(geo):
    """``dy`` is rounded to bf16 before the weight product, as the bf16
    plain form rounds it; each gradient against both plain forms, with the
    moments of its own yardstick's forward."""
    fwd, bwd, args = _run(geo, torch.bfloat16)
    x, k, g, b, _, _, gout = args
    assert bwd[0].dtype == bwd[1].dtype == torch.bfloat16
    r16 = fc.stem_bwd_reference(*args, EPS)
    _, m32, v32 = fc.stem_fwd_reference(x.float(), k.float(), g, b, EPS)
    r32 = fc.stem_bwd_reference(x.float(), k.float(), g, b, m32, v32, gout.float(), EPS)
    _bf16_pins(bwd, r16, r32, ("grad",) * 4)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_schedule_matches_the_pallas_stem(geo):
    """The model in fp32 against ``pallas_conv.fused_conv_bn_relu`` in
    interpret mode: value and moments at rtol/atol 3e-5 (moments atol 2.5e-6),
    and ``jax.vjp``'s gradients for one upstream gradient at rtol 1e-4 /
    atol 1e-3, as ``tests/test_torch_port_conv.py`` holds the port's op."""
    x, k, g, b = _inputs(*geo, torch.float32, seed=41)
    assert pallas_conv.supports_stem(*geo)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    res_j, vjp = jax.vjp(lambda *a: pallas_conv.fused_conv_bn_relu(*a, eps=EPS, interpret=True),
                         *(j(t) for t in (x, k, g, b)))
    sched = Schedule(x, k)
    fwd, _ = sched.forward(g, b, EPS)
    for name, a, r in zip(NAMES, fwd, res_j):
        rtol, atol = (VAL_RTOL, VAL_ATOL) if name == "out" else (STAT_RTOL, STAT_ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=rtol, atol=atol, err_msg=name)
    gout = _gout(tuple(fwd[0].shape), torch.float32, seed=43)
    grads_j = vjp((j(gout), jnp.zeros_like(res_j[1]), jnp.zeros_like(res_j[2])))
    bwd, _ = sched.backward(g, b, fwd[1], fwd[2], gout, EPS)
    for name, a, r in zip(GRADS, bwd, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_gate_admits_every_stem_case():
    """``supports_stem`` admits the recipe's stem and every ragged case, in
    both compute dtypes (the gate did not narrow with the redesign)."""
    for _, geo, _, _ in chip_smoke.STEM_CASES:
        for dtype in fc.COMPUTE_DTYPES:
            assert fc.supports_stem(*geo, dtype=dtype)
    for geo in GEOMETRIES:
        assert fc.supports_stem(*geo)
