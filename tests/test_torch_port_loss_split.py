"""The loss kernels' split schedule (``csrc/fused_supcon_loss.cu``), modelled
on the CPU.

Both kernels split each row tile's column walk over a cluster of ``S``
CTAs: split ``r`` walks column tiles ``[r·tps, (r+1)·tps)`` of ``BN``
columns (``tps = ceil(ceil(nc / BN) / S)``). The forward keeps per row a
running max ``m``, a sum of exponentials ``s`` about it, a positive-logit
sum ``p`` and a positive count ``c``; after a cluster barrier rank ``r``
combines the ``S`` partials of its ``BM / S`` rows in rank order
(``M = max m_r``, ``s = Σ s_r·exp(m_r − M)``, ``lse = M + log s``). The
backward accumulates a partial ``dF`` of its rows over its columns, and
rank ``r`` sums the ``S`` partial slabs over its ``KMAX / S`` columns of
each ``KMAX``-wide slab of D, ranks in order. A split with no live column
(past ``nc``, or holding only the row's self column) keeps ``m = NEG`` and
``s = 0``.

The model below is that schedule, with ``BM``, ``BN``, ``S`` and ``KMAX``
read from the kernel's source (and a smaller schedule beside it, so that
the recipe's shapes walk several tiles a split). It is held:

- against ``fused_rows_reference`` / ``fused_bwd_reference`` in float64,
  to 1e-12;
- in fp32 at the pins of ``PERF.md`` §2: ``cnt`` exact, ``loss_row`` and
  ``lse`` rtol 1e-5, ``dF`` atol 1e-5·max|dF|;
- against the Pallas ``_fwd_call`` / ``_bwd_call`` run in interpret mode,
  square and at a row offset, at the same pins.

Geometries: the recipe's N = 512, D = 128; a row count no multiple of BM
with empty splits (N = 74); a split that holds only the self column (65
rows and columns); nr = nc = 2 (the first views of two samples against
their second views); D = 18; D = 200 (two 128-deep chunks, two dF slabs);
SupCon labels at a row offset (the sharded form). Inputs are numpy draws
from fixed seeds.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.ops import pallas_loss
from simclr_pytorch_distributed_tpu_torch.ops import fused_loss
from torch_threads import limit_threads

limit_threads()

SOURCE = Path(fused_loss.__file__).resolve().parents[1] / "csrc" / "fused_supcon_loss.cu"


def _kernel_constants():
    text = SOURCE.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("BM", "BN", "S", "KMAX", "GROUPS")}


KERNEL = _kernel_constants()
# (BM, BN, S, KMAX, GROUPS): the kernel's, and a smaller one that walks
# several tiles a split and several chunks and slabs of D at these sizes
SCHEDULES = [
    pytest.param(tuple(KERNEL[k] for k in ("BM", "BN", "S", "KMAX", "GROUPS")), id="kernel"),
    pytest.param((8, 16, 4, 16, 2), id="small"),
]
NEG = -1e30
TEMP, BASE_TEMP = 0.5, 0.07

# name -> (batch, classes, dim, anchor rows, contrast columns): rows and
# columns are (lo, hi) of the 2·batch view-major rows, or None for all
GEOMETRIES = {
    "recipe N=512": (256, None, 128, None, None),
    "ragged N=74": (37, None, 128, None, None),
    "self-only split": (65, 3, 24, (0, 65), (0, 65)),
    "nr=nc=2": (2, None, 16, (0, 2), (2, 4)),
    "D=18": (37, None, 18, None, None),
    "D=200": (20, None, 200, None, None),
    "SupCon rows 128..255 of 512": (256, 10, 32, (128, 256), None),
}


def _inputs(geometry, dtype, seed=0):
    """The fused_rows arguments and the backward's lse/cnt (the plain
    forward's in ``dtype``, cnt in ``dtype``), as numpy arrays."""
    batch, classes, dim, rows, cols = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2 * batch, dim))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    base = np.arange(batch) if classes is None else rng.integers(0, classes, batch)
    ids = np.tile(base, 2).astype(np.int32)
    gid = np.arange(2 * batch, dtype=np.int32)
    r, c = slice(*(rows or (0, 2 * batch))), slice(*(cols or (0, 2 * batch)))
    f = f.astype(dtype)
    args = (f[r], f[c], ids[r], ids[c], gid[r], gid[c])
    tt = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if cols is None:
        full = [torch.from_numpy(a) for a in (f, f, ids, ids, gid, gid)]
        _, lse, cnt = fused_loss.fused_rows_reference(*full, TEMP, BASE_TEMP)
        lse_r, cnt_r, lse_c, cnt_c = lse[r], cnt[r], lse, cnt
    else:
        _, lse_r, cnt_r = fused_loss.fused_rows_reference(*tt, TEMP, BASE_TEMP)
        _, lse_c, cnt_c = fused_loss.fused_rows_reference(
            *(tt[i] for i in (1, 0, 3, 2, 5, 4)), TEMP, BASE_TEMP)
    stats = tuple(t.numpy().astype(dtype) for t in (lse_r, lse_c, cnt_r, cnt_c))
    coeff = (TEMP / BASE_TEMP) / (2 * batch)
    return tuple(np.ascontiguousarray(a) for a in args), stats, coeff


def split_tiles(nc, bn, s):
    """The column tiles each of the ``s`` splits walks."""
    tiles = -(-nc // bn)
    tps = -(-tiles // s)
    return [range(r * tps, min((r + 1) * tps, tiles)) for r in range(s)]


def depth_parts(d, kmax, groups):
    """Per chunk of D (``kmax`` deep, D rounded up to 4), the depth range
    each of the ``groups`` depth groups takes: ``[[(k0, k1), ...], ...]``."""
    d4 = -(-d // 4) * 4
    dk = min(d4, kmax)
    chunks = []
    for c0 in range(0, d4, dk):
        kw = min(dk, d4 - c0)
        bounds = [c0 + kw // 4 * g // groups * 4 for g in range(groups + 1)]
        chunks.append(list(zip(bounds[:-1], bounds[1:])))
    return chunks


def tile_logits(a, b, kmax, groups, inv_temp):
    """``a @ b.T · inv_temp`` as the kernels sum it: each depth group
    accumulates its part of every chunk, then the groups' partials are
    added in group order."""
    parts = [np.zeros((a.shape[0], b.shape[0]), a.dtype) for _ in range(groups)]
    for chunk in depth_parts(a.shape[1], kmax, groups):
        for g, (k0, k1) in enumerate(chunk):
            parts[g] = parts[g] + a[:, k0:k1] @ b[:, k0:k1].T
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total * inv_temp


def split_partials(frow, fcol, idr, idc, grow, gcol, rows, tiles, schedule, inv_temp):
    """One split's ``(m, s, p, c)`` for anchor rows ``rows``: the online
    log-sum-exp over its column tiles, in walk order."""
    _, bn, _, kmax, groups = schedule
    dtype = frow.dtype.type
    n = rows.stop - rows.start
    m = np.full(n, NEG, dtype)
    s, p, c = (np.zeros(n, dtype) for _ in range(3))
    for t in tiles:
        cols = slice(t * bn, min((t + 1) * bn, fcol.shape[0]))
        logits = tile_logits(frow[rows], fcol[cols], kmax, groups, inv_temp)
        live = grow[rows, None] != gcol[None, cols]
        pos = live & (idr[rows, None] == idc[None, cols])
        nm = np.maximum(m, np.where(live, logits, dtype(NEG)).max(axis=1))
        e = np.exp(np.where(live, logits - nm[:, None], -np.inf))
        s = s * np.exp(m - nm) + e.sum(axis=1)
        m = nm
        p = p + np.where(pos, logits, 0).sum(axis=1)
        c = c + pos.sum(axis=1).astype(dtype)
    return m, s, p, c


def combine(parts):
    """The rank-order combine of the splits' partials of the same rows."""
    mx = np.max([part[0] for part in parts], axis=0)
    s, p, c = (np.zeros_like(mx) for _ in range(3))
    for m_r, s_r, p_r, c_r in parts:
        s = s + s_r * np.exp(m_r - mx)
        p = p + p_r
        c = c + c_r
    return mx + np.log(s), p, c


def model_fwd(frow, fcol, idr, idc, grow, gcol, schedule):
    """``(loss_row, lse, cnt)`` by the forward's schedule; rank ``r`` of
    each row tile writes rows ``[r, r + 1)·BM/S`` of it, and every row is
    written once."""
    bm, bn, s, _, _ = schedule
    dtype = frow.dtype.type
    inv_temp, scale = dtype(1.0 / TEMP), dtype(TEMP / BASE_TEMP)
    nr = frow.shape[0]
    out = [np.zeros(nr, dtype) for _ in range(3)]
    written = np.zeros(nr, int)
    splits = split_tiles(fcol.shape[0], bn, s)
    for row0 in range(0, nr, bm):
        rows = slice(row0, min(row0 + bm, nr))
        parts = [split_partials(frow, fcol, idr, idc, grow, gcol, rows, tiles, schedule, inv_temp)
                 for tiles in splits]
        lse, p, c = combine(parts)
        for rank in range(s):
            lo, hi = rank * bm // s, (rank + 1) * bm // s
            hi = min(hi, rows.stop - row0)
            if lo >= hi:
                continue
            out[0][row0 + lo:row0 + hi] = -scale * (p[lo:hi] / c[lo:hi] - lse[lo:hi])
            out[1][row0 + lo:row0 + hi] = lse[lo:hi]
            out[2][row0 + lo:row0 + hi] = c[lo:hi]
            written[row0 + lo:row0 + hi] += 1
    assert (written == 1).all()
    return tuple(out)


def model_bwd(frow, fcol, idr, idc, grow, gcol, lse_r, lse_c, cnt_r, cnt_c, coeff, schedule):
    """``dF`` of the anchor rows by the backward's schedule: per split a
    partial over its column tiles, then, per ``KMAX``-wide slab of D, rank
    ``r`` sums ranks ``0..S-1`` over its ``KMAX / S`` columns in order;
    every element is written once."""
    bm, bn, s, kmax, groups = schedule
    dtype = frow.dtype.type
    inv_temp = dtype(1.0 / TEMP)
    out_scale = dtype(coeff) * inv_temp
    nr, d = frow.shape
    dk = min(-(-d // 4) * 4, kmax)
    slabs = -(-(-(-d // 4) * 4) // dk)
    out = np.zeros((nr, d), dtype)
    written = np.zeros((nr, d), int)
    for row0 in range(0, nr, bm):
        rows = slice(row0, min(row0 + bm, nr))
        partials = []
        for tiles in split_tiles(fcol.shape[0], bn, s):
            acc = np.zeros((rows.stop - rows.start, d), dtype)
            for t in tiles:
                cols = slice(t * bn, min((t + 1) * bn, fcol.shape[0]))
                logits = tile_logits(frow[rows], fcol[cols], kmax, groups, inv_temp)
                self_mask = grow[rows, None] == gcol[None, cols]
                pos = (~self_mask & (idr[rows, None] == idc[None, cols])).astype(dtype)
                sm_i = np.where(self_mask, 0, np.exp(logits - lse_r[rows, None]))
                sm_j = np.where(self_mask, 0, np.exp(logits - lse_c[None, cols]))
                h = (sm_i - pos / cnt_r[rows, None]) + (sm_j - pos / cnt_c[None, cols])
                acc = acc + h @ fcol[cols]
            partials.append(acc)
        for slab in range(slabs):
            for rank in range(s):
                lo = slab * dk + rank * kmax // s
                hi = min(slab * dk + (rank + 1) * kmax // s, d)
                if lo >= hi:
                    continue
                v = np.zeros((rows.stop - rows.start, hi - lo), dtype)
                for part in partials:
                    v = v + part[:, lo:hi]
                out[rows, lo:hi] = v * out_scale
                written[rows, lo:hi] += 1
    assert (written == 1).all()
    return out


def _reference_fwd(args):
    tt = [torch.from_numpy(a) for a in args]
    return tuple(t.numpy() for t in fused_loss.fused_rows_reference(*tt, TEMP, BASE_TEMP))


def _reference_bwd(args, stats, coeff):
    tt = [torch.from_numpy(a) for a in args + stats]
    return fused_loss.fused_bwd_reference(*tt, TEMP, coeff).numpy()


def _assert_fwd_pins(got, ref):
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=0)


def _assert_df_pin(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_forward_model_matches_reference_in_float64(schedule, geometry):
    args, _, _ = _inputs(geometry, np.float64)
    got = model_fwd(*args, schedule)
    ref = _reference_fwd(args)
    np.testing.assert_array_equal(got[2], ref[2])
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_backward_model_matches_reference_in_float64(schedule, geometry):
    args, stats, coeff = _inputs(geometry, np.float64)
    got = model_bwd(*args, *stats, coeff, schedule)
    ref = _reference_bwd(args, stats, coeff)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_forward_model_meets_the_fp32_pins(schedule, geometry):
    args, _, _ = _inputs(geometry, np.float32)
    _assert_fwd_pins(model_fwd(*args, schedule), _reference_fwd(args))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_backward_model_meets_the_fp32_pins(schedule, geometry):
    args, stats, coeff = _inputs(geometry, np.float32)
    _assert_df_pin(model_bwd(*args, *stats, coeff, schedule), _reference_bwd(args, stats, coeff))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_empty_splits_add_nothing(schedule):
    # N = 74 (kernel: two tiles of 64, six of eight splits empty; small:
    # five tiles of 16 over four splits) and the 65-column block whose last
    # tile holds only column 64, the self column of row 64
    bm, bn, s, _, _ = schedule
    for geometry in ("ragged N=74", "self-only split"):
        args, _, _ = _inputs(geometry, np.float32)
        frow, fcol = args[0], args[1]
        inv_temp = np.float32(1.0 / TEMP)
        splits = split_tiles(fcol.shape[0], bn, s)
        for row0 in range(0, frow.shape[0], bm):
            rows = slice(row0, min(row0 + bm, frow.shape[0]))
            parts = [split_partials(*args, rows, tiles, schedule, inv_temp) for tiles in splits]
            empty = [part for part, tiles in zip(parts, splits) if len(tiles) == 0]
            for m, ssum, p, c in empty:
                assert (m == np.float32(NEG)).all() and not ssum.any() and not p.any()
                assert not c.any()
            live = [part for part, tiles in zip(parts, splits) if len(tiles)]
            for a, b in zip(combine(parts), combine(live)):
                np.testing.assert_array_equal(a, b)
        if geometry == "self-only split":
            last = [i for i, tiles in enumerate(splits) if 64 // bn in tiles][0]
            assert list(splits[last]) == [64 // bn] and fcol.shape[0] == 65
            m, ssum, p, c = split_partials(*args, slice(64, 65), splits[last], schedule, inv_temp)
            assert m[0] == np.float32(NEG) and ssum[0] == 0 and p[0] == 0 and c[0] == 0


@pytest.mark.parametrize("d", [4, 18, 128, 200, 300])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_depth_groups_cover_each_chunk_once(schedule, d):
    _, _, _, kmax, groups = schedule
    covered = []
    for chunk in depth_parts(d, kmax, groups):
        assert len(chunk) == groups
        for k0, k1 in chunk:
            assert k0 % 4 == 0 and k1 % 4 == 0 and k0 <= k1
            covered += range(k0, k1)
    assert covered == list(range(-(-d // 4) * 4))


def test_kernel_schedule_at_the_recipe_and_ragged_shapes():
    bm, bn, s = KERNEL["BM"], KERNEL["BN"], KERNEL["S"]
    assert bm % s == 0 and KERNEL["KMAX"] % s == 0
    # N = 512: 16 row tiles x 8 splits = 128 CTAs of one 64-column tile
    assert -(-512 // bm) * s == 128
    assert [len(t) for t in split_tiles(512, bn, s)] == [1] * 8
    # N = 74: two tiles, six of the eight splits empty
    assert [len(t) for t in split_tiles(74, bn, s)] == [1, 1] + [0] * 6
    # N = 8192: 256 row tiles, 16 column tiles a split
    assert [len(t) for t in split_tiles(8192, bn, s)] == [16] * 8
    # nc = 2: one split holds the only tile
    assert [len(t) for t in split_tiles(2, bn, s)] == [1] + [0] * 7


@pytest.mark.parametrize("row_lo,row_hi", [(0, 48), (16, 32)], ids=["square", "row offset"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_model_matches_the_pallas_kernels(schedule, row_lo, row_hi):
    rng = np.random.default_rng(4)
    n, d = 48, 16
    f = rng.standard_normal((n, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    ids = np.tile(np.arange(n // 2), 2).astype(np.int32)
    gid = np.arange(n, dtype=np.int32)
    rows = slice(row_lo, row_hi)
    args = (f[rows], f, ids[rows], ids, gid[rows], gid)
    j_loss, j_lse, j_cnt = pallas_loss._fwd_call(
        *map(jnp.asarray, args), TEMP, BASE_TEMP, True, 8, 16)
    got = model_fwd(*args, schedule)
    _assert_fwd_pins(got, tuple(np.asarray(a)[:, 0] for a in (j_loss, j_lse, j_cnt)))
    # the columns' statistics: the model's forward over every row
    _, lse_all, cnt_all = model_fwd(f, f, ids, ids, gid, gid, schedule)
    coeff = (TEMP / BASE_TEMP) / n
    j_df = pallas_loss._bwd_call(
        *map(jnp.asarray, args), jnp.asarray(got[1]), jnp.asarray(lse_all),
        jnp.asarray(got[2]), jnp.asarray(cnt_all), TEMP, coeff, True, 8, 16)
    _assert_df_pin(model_bwd(*args, got[1], lse_all, got[2], cnt_all, coeff, schedule),
                   np.asarray(j_df))
