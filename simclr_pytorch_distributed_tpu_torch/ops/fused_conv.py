"""Fused conv + train-mode BN (+ ReLU) ops: hand-written CUDA kernels and
their plain forms, the port's counterpart of the JAX package's
``simclr_pytorch_distributed_tpu/ops/pallas_conv.py``.

- :func:`fused_conv_bn_relu`: the ResNet stem, ``relu(bn_train(conv3x3_s1(x)))``;
  ``stem_fwd``/``stem_bwd`` in ``csrc/fused_conv_bn.cu`` replace
  ``_stem_fwd_kernel``/``_stem_bwd_kernel``.
- :func:`fused_basic_block`: the identity BasicBlock of ResNet-10/18/34,
  ``relu(bn2(conv3x3(relu(bn1(conv3x3(x, k1))), k2)) + x)``;
  ``basic_fwd``/``basic_bwd`` replace ``_block_fwd_kernel``/``_block_bwd_kernel``.
- :func:`fused_projection_block`: the projection BasicBlock (strided first
  3x3 and a 1x1/s conv + BN shortcut); ``proj_fwd``/``proj_bwd`` replace
  ``_proj_fwd_kernel``/``_proj_bwd_kernel``.
- :func:`fused_bottleneck_block`: the ResNet-50 Bottleneck (1x1 -> BN ->
  ReLU -> 3x3/s -> BN -> ReLU -> 1x1 (x4) -> BN, plus the identity or the
  1x1/s conv + BN shortcut, add, ReLU); ``bottleneck_fwd``/``bottleneck_bwd``
  replace ``_bot_fwd_kernel``/``_bot_bwd_kernel``.

They take the JAX package's layout: NHWC activations, HWIO 3x3 kernels and
``[Cin, Cout]`` (or ``(1, 1, Cin, Cout)``) 1x1 kernels, and return the output
plus the batch mean and BIASED variance of every BN, in the order of
``pallas_conv.py``. The caller applies the running-stat update
(``models/norm.py``). The moments are ancillary: their cotangents are
dropped, as in the Pallas ops' custom VJPs, and the backward keeps only
``x``, the weights and the moments (it recomputes the convolutions).

Compute dtype: ``x.dtype``, fp32 or bf16, as the Pallas ops infer it
(``pallas_conv._compute_dtype``). Under bf16 the kernels take bf16 ``x``,
weights and upstream gradient and return bf16 ``out``, ``dx`` and weight
gradients; BN parameters, moments and their gradients are fp32 in both.
The bf16 plain forms round exactly where the Pallas kernels round: operands
and weights to bf16, products in fp32 on the rounded values (exact, so this
is fp32 accumulation of bf16 operands), ``a1``/``a2`` to bf16 before the
next conv, each cotangent before the transposed product and the weight
gradient it feeds, and ``out``, ``dx`` and every ``dW`` at the end; the
pre-BN ``y``, the statistics and the BN backward stay fp32. The public ops
take fp32 weights, hand the kernels copies in the compute dtype and return
their gradients widened back (the VJP of the JAX wrappers'
``kernel.astype(cdt)``).

Dispatch: each entry point first raises unless its ``supports_*`` gate
admits the geometry (on either device); then tensors on the CPU take the
plain PyTorch forms below, forward and
backward (the backward form spells out the Pallas backward's algebra, not
autograd through the plain forward; on the CPU they also run in float64,
the tests' exact yardstick); CUDA tensors launch the kernels or
raise; any other device raises. There is no fallback from a kernel to a
plain form or to another dtype. The ``*_launches`` counters (stem, basic,
proj and bottleneck, forward and backward, each once for fp32 and once
with ``_bf16`` for bf16) count entry-point calls on the card, one per call
however many CUDA kernels the call runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from simclr_pytorch_distributed_tpu_torch.ops import native

stem_fwd_launches = 0
stem_bwd_launches = 0
basic_fwd_launches = 0
basic_bwd_launches = 0
proj_fwd_launches = 0
proj_bwd_launches = 0
bottleneck_fwd_launches = 0
bottleneck_bwd_launches = 0
stem_fwd_bf16_launches = 0
stem_bwd_bf16_launches = 0
basic_fwd_bf16_launches = 0
basic_bwd_bf16_launches = 0
proj_fwd_bf16_launches = 0
proj_bwd_bf16_launches = 0
bottleneck_fwd_bf16_launches = 0
bottleneck_bwd_bf16_launches = 0

# the kernels' compute dtypes (the Pallas ops' _COMPUTE_DTYPES)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

# Rows, and elements of any one tensor, a call may hold: the kernels index
# rows with 32-bit integers.
_MAX_ELEMENTS = 2**31 - 1

_P = ctypes.c_void_p


class StemArgs(ctypes.Structure):
    """Mirror of ``StemArgs`` in ``csrc/fused_conv_bn.cu``."""

    _fields_ = [(name, _P) for name in (
        "x", "k", "kt", "gamma", "beta", "gout", "out", "mean", "var",
        "dx", "dk", "dgamma", "dbeta",
    )] + [(name, ctypes.c_int) for name in ("n", "h", "w", "cin", "cout")] + [
        ("eps", ctypes.c_float),
    ]


class BotArgs(ctypes.Structure):
    """Mirror of ``BotArgs`` in ``csrc/fused_conv_bn.cu``."""

    _fields_ = [(name, _P) for name in (
        "x", "k1", "k2", "k3", "ks", "k1t", "k2t", "k3t", "kst",
        "g1", "b1", "g2", "b2", "g3", "b3", "gs", "bs", "gout", "out",
        "m1", "v1", "m2", "v2", "m3", "v3", "ms", "vs",
        "dx", "dk1", "dk2", "dk3", "dks",
        "dg1", "db1", "dg2", "db2", "dg3", "db3", "dgs", "dbs",
    )] + [(name, ctypes.c_int) for name in (
        "n", "hi", "wi", "cin", "planes", "stride", "proj",
    )] + [("eps", ctypes.c_float)]


class BlockArgs(ctypes.Structure):
    """Mirror of ``BlockArgs`` in ``csrc/fused_conv_bn.cu``."""

    _fields_ = [(name, _P) for name in (
        "x", "k1", "k2", "ks", "k1t", "k2t", "kst",
        "g1", "b1", "g2", "b2", "gs", "bs", "gout", "out",
        "m1", "v1", "m2", "v2", "ms", "vs",
        "dx", "dk1", "dk2", "dks", "dg1", "db1", "dg2", "db2", "dgs", "dbs",
    )] + [(name, ctypes.c_int) for name in ("n", "hi", "wi", "cin", "c", "stride")] + [
        ("eps", ctypes.c_float),
    ]


_ENTRY_POINTS = tuple(
    f"{name}{suffix}" for name in ("stem_fwd", "stem_bwd", "basic_fwd", "basic_bwd", "proj_fwd",
                                   "proj_bwd", "bottleneck_fwd", "bottleneck_bwd")
    for suffix in ("", "_bf16")
)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' signatures on a loaded library."""
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, ctypes.POINTER(ctypes.c_size_t), _P]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(native.load("fused_conv_bn"))


def _run_entry(lib: ctypes.CDLL, name: str, args: ctypes.Structure,
              device: torch.device, stream: Optional[int]) -> None:
    """Size the entry point's workspace, allocate it on ``device`` and
    launch; raises on a non-zero ``cudaError_t``. The workspace is freed on
    return (the caching allocator keeps it ordered on the stream)."""
    fn = getattr(lib, name)
    need = ctypes.c_size_t(0)
    native.raise_on_error(fn(ctypes.byref(args), None, ctypes.byref(need), stream), name)
    ws = torch.empty(max(int(need.value), 1), dtype=torch.uint8, device=device)
    native.raise_on_error(fn(ctypes.byref(args), ws.data_ptr(), None, stream), name)


def _launch(name: str, cdt: torch.dtype, args: ctypes.Structure, device: torch.device) -> None:
    """Launch entry point ``name`` (``name_bf16`` under bf16 compute) on
    ``device``'s current stream and count it."""
    entry = name if cdt == torch.float32 else f"{name}_bf16"
    _run_entry(_library(), entry, args, device, _stream(device))
    globals()[f"{entry}_launches"] += 1


def _check(name: str, t: torch.Tensor, shape: Sequence[int],
           dtype: Optional[torch.dtype] = None) -> None:
    """Check a launch operand: with ``dtype``, one in the compute dtype (an
    activation, a kernel or an upstream gradient), which the kernels load
    16 bytes at a time; without, an fp32 per-channel row."""
    native.check_tensor(name, t, dtype or torch.float32, shape, 1 if dtype is None else 16)


def _launch_dtype(x: torch.Tensor) -> torch.dtype:
    """The compute dtype of a launch: ``x.dtype``, which must be fp32 or bf16."""
    if x.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"the fused conv kernels compute in {COMPUTE_DTYPES}, got x {x.dtype}")
    return x.dtype


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Admission gates (Hopper). The kernels' shared memory is the same for
# every geometry (dynamic: 63-70 KB in the stem's passes, 43-55 KB fp32 and
# 96-128 KB bf16 in the pipelined core every block entry point runs on) and
# their register use is fixed by the tile, so nothing here depends on a
# memory budget: the gates hold the geometric rules the
# kernels rely on and the 32-bit index range. They take the compute dtype,
# as the Pallas gates do, but it does not change their answer (the Pallas
# gates' VMEM model admits more sites under bf16; these admit fp32 and
# bf16 alike); a launch rejects any dtype outside COMPUTE_DTYPES.
# ---------------------------------------------------------------------------


def supports_stem(n: int, h: int, w: int, cin: int, cout: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """True if the fused stem kernels admit ``[n, h, w, cin] -> cout``
    (``dtype``, the compute dtype, does not change the answer)."""
    if min(n, h, w, cin, cout) < 1:
        return False
    return n * h * w * max(cin, cout) <= _MAX_ELEMENTS


def _admit_stem(x, k):
    """Raise unless ``supports_stem`` admits ``x`` and ``k`` (both devices)."""
    n, h, w, cin = x.shape
    if not supports_stem(n, h, w, cin, k.shape[3]):
        raise ValueError(f"fused stem does not admit [{n},{h},{w},{cin}]->{k.shape[3]} "
                         f"{x.dtype}")


def supports_block(n: int, h: int, w: int, c: int, *, stride: int = 1,
                   in_channels: Optional[int] = None,
                   dtype: torch.dtype = torch.float32) -> bool:
    """True if the fused BasicBlock kernels admit this geometry (``dtype``,
    the compute dtype, does not change the answer): the
    identity kernels at stride 1 with ``in_channels == c`` (the default),
    the projection kernels otherwise. ``h``/``w`` are the block's INPUT
    spatial dims; stride 2 needs them even (the transposed-conv backward
    assumes ``ho == h // 2`` exactly)."""
    cin = c if in_channels is None else in_channels
    if stride not in (1, 2):
        return False
    if min(n, h, w, c, cin) < 1:
        return False
    if stride == 2 and (h % 2 or w % 2):
        return False
    return n * h * w * max(cin, c) <= _MAX_ELEMENTS


def _admit_block(x, k1, stride, proj):
    """Raise unless ``supports_block`` admits ``x`` and the geometry is the
    kernels' kind (identity: stride 1 and ``cin == c``), on both devices."""
    n, h, w, cin = x.shape
    c = k1.shape[3]
    if not supports_block(n, h, w, c, stride=stride, in_channels=cin):
        raise ValueError(f"fused BasicBlock does not admit [{n},{h},{w},{cin}]->{c}/s{stride} "
                         f"{x.dtype}")
    if proj == (stride == 1 and cin == c):
        raise ValueError(f"[{n},{h},{w},{cin}]->{c}/s{stride} is "
                         f"{'an identity' if proj else 'a projection'} geometry; the "
                         f"{'projection' if proj else 'identity'} BasicBlock kernels do not take it")


def supports_bottleneck(n: int, h: int, w: int, planes: int, *,
                        stride: int = 1, in_channels: int,
                        dtype: torch.dtype = torch.float32) -> bool:
    """True if the fused Bottleneck kernels admit this geometry (``dtype``,
    the compute dtype, does not change the answer). ``h``/``w``
    are the block's INPUT spatial dims; stride 2 needs them even (the
    transposed-conv backward assumes ``ho == h // 2`` exactly)."""
    if stride not in (1, 2):
        return False
    if min(n, h, w, planes, in_channels) < 1:
        return False
    if stride == 2 and (h % 2 or w % 2):
        return False
    return n * h * w * max(in_channels, 4 * planes) <= _MAX_ELEMENTS


def _admit_bottleneck(x, k2, stride):
    """Raise unless ``supports_bottleneck`` admits ``x`` (both devices)."""
    n, h, w, cin = x.shape
    p = k2.shape[2]
    if not supports_bottleneck(n, h, w, p, stride=stride, in_channels=cin):
        raise ValueError(f"fused bottleneck does not admit [{n},{h},{w},{cin}] "
                         f"planes={p}/s{stride} {x.dtype}")


# ---------------------------------------------------------------------------
# Plain forms: the same functions in PyTorch (the CPU path, and the card's
# yardstick in chip_smoke.py).
# ---------------------------------------------------------------------------


def _as4(k: torch.Tensor) -> torch.Tensor:
    """A 1x1 kernel ``[cin, cout]`` as HWIO ``[1, 1, cin, cout]``."""
    return k.reshape(1, 1, *k.shape) if k.dim() == 2 else k


def _conv(x: torch.Tensor, k: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` convolved with HWIO (or 2-D 1x1) ``k``: pad 1 for 3x3, 0 for 1x1."""
    k4 = _as4(k)
    pad = (k4.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), k4.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _flip_transpose(k: torch.Tensor) -> torch.Tensor:
    """The weight of the transposed conv that computes dx from dy
    (``pallas_conv._flip_transpose``)."""
    return k.flip(0, 1).permute(0, 1, 3, 2)


def _dilate(v: torch.Tensor, stride: int, h: int, w: int) -> torch.Tensor:
    """``out[:, s*i, s*j] = v[:, i, j]``, zeros elsewhere (``_dilate2``)."""
    if stride == 1:
        return v
    out = v.new_zeros((v.shape[0], h, w, v.shape[3]))
    out[:, ::stride, ::stride] = v
    return out


def _conv_dx(dy: torch.Tensor, k: torch.Tensor, stride: int, h: int, w: int) -> torch.Tensor:
    """Data gradient, as the Pallas backward builds it: 1x1 as ``dy @ kᵀ``
    then dilated; 3x3 as the flip-transposed 3x3 over the dilated ``dy``."""
    if k.dim() == 2:
        return _dilate(dy @ k.T, stride, h, w)
    return _conv(_dilate(dy, stride, h, w), _flip_transpose(k), 1)


def _conv_dw(x: torch.Tensor, dy: torch.Tensor, k_shape, stride: int) -> torch.Tensor:
    """Weight gradient as the sum over window offsets of
    ``x_window(d)ᵀ @ dy`` (``pallas_conv._dw_accumulate``)."""
    n, ho, wo, cout = dy.shape
    d2 = dy.reshape(-1, cout)
    cin = x.shape[3]
    if len(k_shape) == 2:
        return x[:, ::stride, ::stride, :].reshape(-1, cin).T @ d2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [
        xp[:, di:di + stride * ho:stride, dj:dj + stride * wo:stride, :].reshape(-1, cin).T @ d2
        for di in range(3) for dj in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, cin, cout)


def _moments(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel batch mean and biased variance of an NHWC tensor."""
    v, m = torch.var_mean(y, dim=(0, 1, 2), correction=0)
    return m, v


def _fold(m, v, g, b, eps):
    """``(rstd, scale, shift)`` with ``scale = g * rstd``, ``shift = b - m * scale``."""
    rs = torch.rsqrt(v + eps)
    s = g * rs
    return rs, s, b - m * s


def _bn_bwd(dp, yh, rs, g, count):
    """Train-mode BN backward from the upstream ``dp``: ``(dy, dgamma, dbeta)``."""
    db = dp.sum(dim=(0, 1, 2))
    dg = (dp * yh).sum(dim=(0, 1, 2))
    dy = rs * g * (dp - db / count - yh * dg / count)
    return dy, dg, db


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand as fp32 (exact); fp32 and float64 pass through."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _rnd(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to bf16 and held in fp32 when the compute dtype ``cdt``
    is bf16 (a Pallas kernel's cast to its compute dtype); else ``t``."""
    return t.to(cdt).float() if cdt == torch.bfloat16 else t


def stem_fwd_reference(x, k, g, b, eps):
    """Plain form of ``stem_fwd``: ``(out, mean, var_biased)``."""
    y = _conv(_wide(x), _wide(k))
    m, v = _moments(y)
    _, s, t = _fold(m, v, g, b, eps)
    return torch.relu(y * s + t).to(x.dtype), m, v


def stem_bwd_reference(x, k, g, b, m, v, gout, eps, need_dx=True):
    """Plain form of ``stem_bwd`` (``pallas_conv.py:460-489``):
    ``(dx or None, dk, dgamma, dbeta)``."""
    cdt = x.dtype
    n, h, w, _ = x.shape
    x, k = _wide(x), _wide(k)
    rs = torch.rsqrt(v + eps)
    yh = (_conv(x, k) - m) * rs
    dp = _wide(gout) * (yh * g + b > 0)
    dy, dg, db = _bn_bwd(dp, yh, rs, g, n * h * w)
    dy = _rnd(dy, cdt)
    dk = _conv_dw(x, dy, k.shape, 1).to(cdt)
    dx = _conv_dx(dy, k, 1, h, w).to(cdt) if need_dx else None
    return dx, dk, dg, db


def bottleneck_fwd_reference(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, eps):
    """Plain form of ``bottleneck_fwd`` (``pallas_conv.py:1362-1405``):
    ``(out, m1, v1, m2, v2, m3, v3[, mS, vS])``; ``short`` is
    ``(ks, gs, bs)`` or ``None``."""
    cdt = x.dtype
    x, k1, k2, k3 = (_wide(t) for t in (x, k1, k2, k3))
    y1 = _conv(x, k1)
    m1, v1 = _moments(y1)
    _, s1, t1 = _fold(m1, v1, g1, b1, eps)
    y2 = _conv(_rnd(torch.relu(y1 * s1 + t1), cdt), k2, stride)
    m2, v2 = _moments(y2)
    _, s2, t2 = _fold(m2, v2, g2, b2, eps)
    y3 = _conv(_rnd(torch.relu(y2 * s2 + t2), cdt), k3)
    m3, v3 = _moments(y3)
    _, s3, t3 = _fold(m3, v3, g3, b3, eps)
    if short is None:
        return (torch.relu(y3 * s3 + t3 + x).to(cdt), m1, v1, m2, v2, m3, v3)
    ks, gs, bs = short
    ys = _conv(x, _wide(ks), stride)
    ms, vs = _moments(ys)
    _, ss, ts = _fold(ms, vs, gs, bs, eps)
    out = torch.relu(y3 * s3 + t3 + (ys * ss + ts))
    return (out.to(cdt), m1, v1, m2, v2, m3, v3, ms, vs)


def bottleneck_bwd_reference(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short,
                             m1, v1, m2, v2, m3, v3, gout, stride, eps):
    """Plain form of ``bottleneck_bwd`` (``pallas_conv.py:1445-1562``):
    ``(dx, dk1, dg1, db1, dk2, dg2, db2, dk3, dg3, db3[, dks, dgs, dbs])``;
    ``short`` is ``(ks, gs, bs, mS, vS)`` or ``None``."""
    cdt = x.dtype
    n, hi, wi, _ = x.shape
    x, k1, k2, k3 = (_wide(t) for t in (x, k1, k2, k3))
    ho, wo = hi // stride, wi // stride
    count1, count2 = n * hi * wi, n * ho * wo
    rs1, rs2, rs3 = (torch.rsqrt(v + eps) for v in (v1, v2, v3))
    y1 = _conv(x, k1)
    yh1 = (y1 - m1) * rs1
    p1 = yh1 * g1 + b1
    a1 = _rnd(torch.relu(p1), cdt)
    yh2 = (_conv(a1, k2, stride) - m2) * rs2
    p2 = yh2 * g2 + b2
    a2 = _rnd(torch.relu(p2), cdt)
    yh3 = (_conv(a2, k3) - m3) * rs3
    z = yh3 * g3 + b3
    if short is not None:
        ks, gs, bs, ms, vs = short
        ks = _wide(ks)
        rss = torch.rsqrt(vs + eps)
        yhs = (_conv(x, ks, stride) - ms) * rss
        z = z + yhs * gs + bs
    else:
        z = z + x
    dz = _wide(gout) * (z > 0)
    dy3, dg3, db3 = _bn_bwd(dz, yh3, rs3, g3, count2)
    dy3 = _rnd(dy3, cdt)
    dk3 = _conv_dw(a2, dy3, k3.shape, 1)
    dp2 = _conv_dx(dy3, k3, 1, ho, wo) * (p2 > 0)
    dy2, dg2, db2 = _bn_bwd(dp2, yh2, rs2, g2, count2)
    dy2 = _rnd(dy2, cdt)
    dk2 = _conv_dw(a1, dy2, k2.shape, stride)
    dp1 = _conv_dx(dy2, k2, stride, hi, wi) * (p1 > 0)
    dy1, dg1, db1 = _bn_bwd(dp1, yh1, rs1, g1, count1)
    dy1 = _rnd(dy1, cdt)
    dk1 = _conv_dw(x, dy1, k1.shape, 1)
    dx = _conv_dx(dy1, k1, 1, hi, wi)
    grads = (dk1.to(cdt), dg1, db1, dk2.to(cdt), dg2, db2, dk3.to(cdt), dg3, db3)
    if short is None:
        return ((dx + dz).to(cdt),) + grads
    dys, dgs, dbs = _bn_bwd(dz, yhs, rss, gs, count2)
    dys = _rnd(dys, cdt)
    dks = _conv_dw(x, dys, ks.shape, stride)
    dx = dx + _conv_dx(dys, ks, stride, hi, wi)
    return (dx.to(cdt),) + grads + (dks.to(cdt), dgs, dbs)


def _block_fwd_reference(x, k1, g1, b1, k2, g2, b2, short, stride, eps):
    """The BasicBlock forward, ``short`` ``(ks, gs, bs)`` or ``None``."""
    cdt = x.dtype
    x, k1, k2 = _wide(x), _wide(k1), _wide(k2)
    y1 = _conv(x, k1, stride)
    m1, v1 = _moments(y1)
    _, s1, t1 = _fold(m1, v1, g1, b1, eps)
    y2 = _conv(_rnd(torch.relu(y1 * s1 + t1), cdt), k2)
    m2, v2 = _moments(y2)
    _, s2, t2 = _fold(m2, v2, g2, b2, eps)
    if short is None:
        return (torch.relu(y2 * s2 + t2 + x).to(cdt), m1, v1, m2, v2)
    ks, gs, bs = short
    ys = _conv(x, _wide(ks), stride)
    ms, vs = _moments(ys)
    _, ss, ts = _fold(ms, vs, gs, bs, eps)
    return (torch.relu(y2 * s2 + t2 + (ys * ss + ts)).to(cdt), m1, v1, m2, v2, ms, vs)


def _block_bwd_reference(x, k1, g1, b1, k2, g2, b2, short, m1, v1, m2, v2, gout,
                         stride, eps):
    """The BasicBlock backward, ``short`` ``(ks, gs, bs, mS, vS)`` or
    ``None``. Every BN counts over the output grid."""
    cdt = x.dtype
    n, hi, wi, _ = x.shape
    x, k1, k2 = _wide(x), _wide(k1), _wide(k2)
    ho, wo = hi // stride, wi // stride
    count = n * ho * wo
    rs1, rs2 = torch.rsqrt(v1 + eps), torch.rsqrt(v2 + eps)
    yh1 = (_conv(x, k1, stride) - m1) * rs1
    p1 = yh1 * g1 + b1
    a1 = _rnd(torch.relu(p1), cdt)
    yh2 = (_conv(a1, k2) - m2) * rs2
    z = yh2 * g2 + b2
    if short is not None:
        ks, gs, bs, ms, vs = short
        ks = _wide(ks)
        rss = torch.rsqrt(vs + eps)
        yhs = (_conv(x, ks, stride) - ms) * rss
        z = z + yhs * gs + bs
    else:
        z = z + x
    dz = _wide(gout) * (z > 0)
    dy2, dg2, db2 = _bn_bwd(dz, yh2, rs2, g2, count)
    dy2 = _rnd(dy2, cdt)
    dk2 = _conv_dw(a1, dy2, k2.shape, 1)
    dp1 = _conv_dx(dy2, k2, 1, ho, wo) * (p1 > 0)
    dy1, dg1, db1 = _bn_bwd(dp1, yh1, rs1, g1, count)
    dy1 = _rnd(dy1, cdt)
    dk1 = _conv_dw(x, dy1, k1.shape, stride)
    dx = _conv_dx(dy1, k1, stride, hi, wi)
    if short is None:
        return ((dx + dz).to(cdt), dk1.to(cdt), dk2.to(cdt), dg1, db1, dg2, db2)
    dys, dgs, dbs = _bn_bwd(dz, yhs, rss, gs, count)
    dys = _rnd(dys, cdt)
    dks = _conv_dw(x, dys, ks.shape, stride)
    dx = dx + _conv_dx(dys, ks, stride, hi, wi)
    return (dx.to(cdt), dk1.to(cdt), dk2.to(cdt), dks.to(cdt), dg1, db1, dg2, db2, dgs, dbs)


def basic_block_fwd_reference(x, k1, g1, b1, k2, g2, b2, eps):
    """Plain form of ``basic_fwd`` (``pallas_conv.py:639-702``):
    ``(out, m1, v1, m2, v2)``."""
    return _block_fwd_reference(x, k1, g1, b1, k2, g2, b2, None, 1, eps)


def basic_block_bwd_reference(x, k1, g1, b1, k2, g2, b2, m1, v1, m2, v2, gout, eps):
    """Plain form of ``basic_bwd`` (``pallas_conv.py:705-785``):
    ``(dx, dk1, dk2, dg1, db1, dg2, db2)`` with ``dx = dz + conv1ᵀ(dy1)``."""
    return _block_bwd_reference(x, k1, g1, b1, k2, g2, b2, None, m1, v1, m2, v2, gout,
                                1, eps)


def proj_block_fwd_reference(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, stride, eps):
    """Plain form of ``proj_fwd`` (``pallas_conv.py:930-1003``):
    ``(out, m1, v1, m2, v2, mS, vS)``; ``ks`` is ``[cin, c]``."""
    return _block_fwd_reference(x, k1, g1, b1, k2, g2, b2, (ks, gs, bs), stride, eps)


def proj_block_bwd_reference(x, k1, g1, b1, k2, g2, b2, ks, gs, bs,
                             m1, v1, m2, v2, ms, vs, gout, stride, eps):
    """Plain form of ``proj_bwd`` (``pallas_conv.py:1006-1105``):
    ``(dx, dk1, dk2, dks, dg1, db1, dg2, db2, dgS, dbS)``, ``dbS == db2``."""
    return _block_bwd_reference(x, k1, g1, b1, k2, g2, b2, (ks, gs, bs, ms, vs),
                                m1, v1, m2, v2, gout, stride, eps)


# ---------------------------------------------------------------------------
# Entry points: plain form on the CPU, kernels on the card.
# ---------------------------------------------------------------------------


def stem_fwd(x, k, g, b, eps):
    """``(out, mean, var_biased)`` of the stem; launches ``stem_fwd`` (or
    ``stem_fwd_bf16``) for CUDA tensors."""
    _admit_stem(x, k)
    if native.on_cpu(x, k, g, b):
        return stem_fwd_reference(x, k, g, b, eps)
    n, h, w, cin = x.shape
    cout = k.shape[3]
    cdt = _launch_dtype(x)
    _check_stem(x, k, g, b, n, h, w, cin, cout, cdt)
    out = torch.empty((n, h, w, cout), dtype=cdt, device=x.device)
    m, v = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    args = StemArgs(
        x=_ptr(x), k=_ptr(k), gamma=_ptr(g), beta=_ptr(b), out=_ptr(out),
        mean=_ptr(m), var=_ptr(v), n=n, h=h, w=w, cin=cin, cout=cout, eps=eps,
    )
    _launch("stem_fwd", cdt, args, x.device)
    return out, m, v


def stem_bwd(x, k, g, b, m, v, gout, eps, need_dx=True):
    """``(dx or None, dk, dgamma, dbeta)`` of the stem; launches
    ``stem_bwd`` (or ``stem_bwd_bf16``) for CUDA tensors."""
    _admit_stem(x, k)
    if native.on_cpu(x, k, g, b, m, v, gout):
        return stem_bwd_reference(x, k, g, b, m, v, gout, eps, need_dx)
    n, h, w, cin = x.shape
    cout = k.shape[3]
    cdt = _launch_dtype(x)
    _check_stem(x, k, g, b, n, h, w, cin, cout, cdt)
    for name, t, shape in (("mean", m, (cout,)), ("var", v, (cout,))):
        _check(name, t, shape)
    _check("gout", gout, (n, h, w, cout), cdt)
    kt = k.permute(0, 1, 3, 2).contiguous() if need_dx else None
    dx = torch.empty_like(x) if need_dx else None
    dk = torch.empty_like(k)
    dg, db = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    args = StemArgs(
        x=_ptr(x), k=_ptr(k), kt=_ptr(kt), gamma=_ptr(g), beta=_ptr(b),
        gout=_ptr(gout), mean=_ptr(m), var=_ptr(v), dx=_ptr(dx), dk=_ptr(dk),
        dgamma=_ptr(dg), dbeta=_ptr(db), n=n, h=h, w=w, cin=cin, cout=cout, eps=eps,
    )
    _launch("stem_bwd", cdt, args, x.device)
    return dx, dk, dg, db


def _check_stem(x, k, g, b, n, h, w, cin, cout, cdt):
    if x.dim() != 4 or k.dim() != 4 or k.shape[:3] != (3, 3, cin):
        raise ValueError(f"stem: x [n,h,w,cin] and k [3,3,cin,cout], got "
                         f"{tuple(x.shape)} and {tuple(k.shape)}")
    _check("x", x, (n, h, w, cin), cdt)
    _check("k", k, (3, 3, cin, cout), cdt)
    _check("gamma", g, (cout,))
    _check("beta", b, (cout,))


def _bot_shapes(x, k2):
    n, hi, wi, cin = x.shape
    return n, hi, wi, cin, k2.shape[2]


def _check_bottleneck(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, cdt):
    n, hi, wi, cin, p = _bot_shapes(x, k2)
    for name, t, shape in (
        ("x", x, (n, hi, wi, cin)), ("k1", k1, (cin, p)), ("k2", k2, (3, 3, p, p)),
        ("k3", k3, (p, 4 * p)),
    ):
        _check(name, t, shape, cdt)
    for name, t, shape in (
        ("g1", g1, (p,)), ("b1", b1, (p,)),
        ("g2", g2, (p,)), ("b2", b2, (p,)), ("g3", g3, (4 * p,)), ("b3", b3, (4 * p,)),
    ):
        _check(name, t, shape)
    if short is not None:
        for name, t, shape in zip(("ks", "gs", "bs", "ms", "vs"), short,
                                  ((cin, 4 * p),) + ((4 * p,),) * 4):
            _check(name, t, shape, cdt if name == "ks" else None)


def bottleneck_fwd(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, eps):
    """Bottleneck forward (see :func:`bottleneck_fwd_reference`); launches
    ``bottleneck_fwd`` (or ``bottleneck_fwd_bf16``) for CUDA tensors."""
    _admit_bottleneck(x, k2, stride)
    tensors = (x, k1, g1, b1, k2, g2, b2, k3, g3, b3) + tuple(short or ())
    if native.on_cpu(*tensors):
        return bottleneck_fwd_reference(x, k1, g1, b1, k2, g2, b2, k3, g3, b3,
                                        short, stride, eps)
    cdt = _launch_dtype(x)
    _check_bottleneck(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, cdt)
    n, hi, wi, cin, p = _bot_shapes(x, k2)
    dev = x.device
    out = torch.empty((n, hi // stride, wi // stride, 4 * p), dtype=cdt, device=dev)
    m1, v1, m2, v2 = torch.empty((4, p), dtype=torch.float32, device=dev)
    wide = torch.empty((4 if short is not None else 2, 4 * p), dtype=torch.float32, device=dev)
    ks, gs, bs = short if short is not None else (None, None, None)
    args = BotArgs(
        x=_ptr(x), k1=_ptr(k1), k2=_ptr(k2), k3=_ptr(k3), ks=_ptr(ks),
        g1=_ptr(g1), b1=_ptr(b1), g2=_ptr(g2), b2=_ptr(b2), g3=_ptr(g3), b3=_ptr(b3),
        gs=_ptr(gs), bs=_ptr(bs), out=_ptr(out),
        m1=_ptr(m1), v1=_ptr(v1), m2=_ptr(m2), v2=_ptr(v2),
        m3=_ptr(wide[0]), v3=_ptr(wide[1]),
        ms=_ptr(wide[2]) if short is not None else None,
        vs=_ptr(wide[3]) if short is not None else None,
        n=n, hi=hi, wi=wi, cin=cin, planes=p, stride=stride,
        proj=int(short is not None), eps=eps,
    )
    _launch("bottleneck_fwd", cdt, args, dev)
    return (out, m1, v1, m2, v2) + tuple(wide.unbind(0))


def bottleneck_bwd(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short,
                   m1, v1, m2, v2, m3, v3, gout, stride, eps):
    """Bottleneck backward (see :func:`bottleneck_bwd_reference`); launches
    ``bottleneck_bwd`` (or ``bottleneck_bwd_bf16``) for CUDA tensors."""
    _admit_bottleneck(x, k2, stride)
    tensors = (x, k1, g1, b1, k2, g2, b2, k3, g3, b3, m1, v1, m2, v2, m3, v3,
               gout) + tuple(short or ())
    if native.on_cpu(*tensors):
        return bottleneck_bwd_reference(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short,
                                        m1, v1, m2, v2, m3, v3, gout, stride, eps)
    cdt = _launch_dtype(x)
    _check_bottleneck(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, cdt)
    n, hi, wi, cin, p = _bot_shapes(x, k2)
    for name, t, shape in (("m1", m1, (p,)), ("v1", v1, (p,)), ("m2", m2, (p,)),
                           ("v2", v2, (p,)), ("m3", m3, (4 * p,)), ("v3", v3, (4 * p,))):
        _check(name, t, shape)
    _check("gout", gout, (n, hi // stride, wi // stride, 4 * p), cdt)
    dev = x.device
    proj = short is not None
    ks, gs, bs, ms, vs = short if proj else (None,) * 5
    dx = torch.empty_like(x)
    dk1, dk2, dk3 = torch.empty_like(k1), torch.empty_like(k2), torch.empty_like(k3)
    dks = torch.empty_like(ks) if proj else None
    dg1, db1, dg2, db2 = torch.empty((4, p), dtype=torch.float32, device=dev)
    wide = torch.empty((4 if proj else 2, 4 * p), dtype=torch.float32, device=dev)
    args = BotArgs(
        x=_ptr(x), k1=_ptr(k1), k2=_ptr(k2), k3=_ptr(k3), ks=_ptr(ks),
        g1=_ptr(g1), b1=_ptr(b1), g2=_ptr(g2), b2=_ptr(b2), g3=_ptr(g3), b3=_ptr(b3),
        gs=_ptr(gs), bs=_ptr(bs), gout=_ptr(gout),
        m1=_ptr(m1), v1=_ptr(v1), m2=_ptr(m2), v2=_ptr(v2), m3=_ptr(m3), v3=_ptr(v3),
        ms=_ptr(ms), vs=_ptr(vs),
        dx=_ptr(dx), dk1=_ptr(dk1), dk2=_ptr(dk2), dk3=_ptr(dk3), dks=_ptr(dks),
        dg1=_ptr(dg1), db1=_ptr(db1), dg2=_ptr(dg2), db2=_ptr(db2),
        dg3=_ptr(wide[0]), db3=_ptr(wide[1]),
        dgs=_ptr(wide[2]) if proj else None, dbs=_ptr(wide[3]) if proj else None,
        n=n, hi=hi, wi=wi, cin=cin, planes=p, stride=stride, proj=int(proj), eps=eps,
    )
    # the data-gradient weights, channel axes swapped (made here, O(C^2))
    transposed = {
        "k1t": k1.T.contiguous(), "k2t": k2.permute(0, 1, 3, 2).contiguous(),
        "k3t": k3.T.contiguous(), "kst": ks.T.contiguous() if proj else None,
    }
    for name, t in transposed.items():
        setattr(args, name, _ptr(t))
    _launch("bottleneck_bwd", cdt, args, dev)
    grads = (dk1, dg1, db1, dk2, dg2, db2, dk3, wide[0], wide[1])
    if not proj:
        return (dx,) + grads
    return (dx,) + grads + (dks, wide[2], wide[3])


def _block_tensors(x, k1, k2, short, cdt):
    """Check the BasicBlock operands for a launch; ``(n, hi, wi, cin, c)``."""
    n, hi, wi, cin = x.shape
    c = k1.shape[3]
    _check("x", x, (n, hi, wi, cin), cdt)
    _check("k1", k1, (3, 3, cin, c), cdt)
    _check("k2", k2, (3, 3, c, c), cdt)
    for name, t in zip(("ks", "gs", "bs", "ms", "vs"), short or ()):
        if name == "ks":
            _check(name, t, (cin, c), cdt)
        else:
            _check(name, t, (c,))
    return n, hi, wi, cin, c


def _block_fwd(name, x, k1, g1, b1, k2, g2, b2, short, stride, eps):
    """Launch ``basic_fwd`` (``short`` None) or ``proj_fwd``, or their bf16
    twins."""
    cdt = _launch_dtype(x)
    n, hi, wi, cin, c = _block_tensors(x, k1, k2, short, cdt)
    for label, t in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2)):
        _check(label, t, (c,))
    dev = x.device
    out = torch.empty((n, hi // stride, wi // stride, c), dtype=cdt, device=dev)
    moments = torch.empty((6 if short else 4, c), dtype=torch.float32, device=dev)
    ks, gs, bs = short or (None, None, None)
    args = BlockArgs(
        x=_ptr(x), k1=_ptr(k1), k2=_ptr(k2), ks=_ptr(ks), g1=_ptr(g1), b1=_ptr(b1),
        g2=_ptr(g2), b2=_ptr(b2), gs=_ptr(gs), bs=_ptr(bs), out=_ptr(out),
        m1=_ptr(moments[0]), v1=_ptr(moments[1]), m2=_ptr(moments[2]), v2=_ptr(moments[3]),
        ms=_ptr(moments[4]) if short else None, vs=_ptr(moments[5]) if short else None,
        n=n, hi=hi, wi=wi, cin=cin, c=c, stride=stride, eps=eps,
    )
    _launch(name, cdt, args, dev)
    return (out,) + tuple(moments.unbind(0))


def _block_bwd(name, x, k1, g1, b1, k2, g2, b2, short, m1, v1, m2, v2, gout, stride, eps):
    """Launch ``basic_bwd`` (``short`` None) or ``proj_bwd``, or their bf16
    twins."""
    cdt = _launch_dtype(x)
    n, hi, wi, cin, c = _block_tensors(x, k1, k2, short, cdt)
    for label, t in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2), ("m1", m1),
                     ("v1", v1), ("m2", m2), ("v2", v2)):
        _check(label, t, (c,))
    _check("gout", gout, (n, hi // stride, wi // stride, c), cdt)
    dev = x.device
    ks, gs, bs, ms, vs = short or (None,) * 5
    dx, dk1, dk2 = torch.empty_like(x), torch.empty_like(k1), torch.empty_like(k2)
    dks = torch.empty_like(ks) if short else None
    rows = torch.empty((6 if short else 4, c), dtype=torch.float32, device=dev)
    # the data-gradient weights, channel axes swapped (made here, O(C^2))
    k1t, k2t = k1.permute(0, 1, 3, 2).contiguous(), k2.permute(0, 1, 3, 2).contiguous()
    kst = ks.T.contiguous() if short else None
    args = BlockArgs(
        x=_ptr(x), k1=_ptr(k1), k2=_ptr(k2), ks=_ptr(ks), k1t=_ptr(k1t), k2t=_ptr(k2t),
        kst=_ptr(kst), g1=_ptr(g1), b1=_ptr(b1), g2=_ptr(g2), b2=_ptr(b2), gs=_ptr(gs),
        bs=_ptr(bs), gout=_ptr(gout), m1=_ptr(m1), v1=_ptr(v1), m2=_ptr(m2), v2=_ptr(v2),
        ms=_ptr(ms), vs=_ptr(vs), dx=_ptr(dx), dk1=_ptr(dk1), dk2=_ptr(dk2), dks=_ptr(dks),
        dg1=_ptr(rows[0]), db1=_ptr(rows[1]), dg2=_ptr(rows[2]), db2=_ptr(rows[3]),
        dgs=_ptr(rows[4]) if short else None, dbs=_ptr(rows[5]) if short else None,
        n=n, hi=hi, wi=wi, cin=cin, c=c, stride=stride, eps=eps,
    )
    _launch(name, cdt, args, dev)
    if not short:
        return (dx, dk1, dk2) + tuple(rows.unbind(0))
    return (dx, dk1, dk2, dks) + tuple(rows.unbind(0))


def basic_fwd(x, k1, g1, b1, k2, g2, b2, eps):
    """Identity BasicBlock forward (see :func:`basic_block_fwd_reference`);
    launches ``basic_fwd`` (or ``basic_fwd_bf16``) for CUDA tensors."""
    _admit_block(x, k1, 1, proj=False)
    if native.on_cpu(x, k1, g1, b1, k2, g2, b2):
        return basic_block_fwd_reference(x, k1, g1, b1, k2, g2, b2, eps)
    return _block_fwd("basic_fwd", x, k1, g1, b1, k2, g2, b2, None, 1, eps)


def basic_bwd(x, k1, g1, b1, k2, g2, b2, m1, v1, m2, v2, gout, eps):
    """Identity BasicBlock backward (see :func:`basic_block_bwd_reference`);
    launches ``basic_bwd`` (or ``basic_bwd_bf16``) for CUDA tensors."""
    _admit_block(x, k1, 1, proj=False)
    if native.on_cpu(x, k1, g1, b1, k2, g2, b2, m1, v1, m2, v2, gout):
        return basic_block_bwd_reference(x, k1, g1, b1, k2, g2, b2, m1, v1, m2, v2, gout, eps)
    return _block_bwd("basic_bwd", x, k1, g1, b1, k2, g2, b2, None, m1, v1, m2, v2, gout, 1,
                      eps)


def proj_fwd(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, stride, eps):
    """Projection BasicBlock forward (see :func:`proj_block_fwd_reference`);
    launches ``proj_fwd`` (or ``proj_fwd_bf16``) for CUDA tensors."""
    _admit_block(x, k1, stride, proj=True)
    if native.on_cpu(x, k1, g1, b1, k2, g2, b2, ks, gs, bs):
        return proj_block_fwd_reference(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, stride, eps)
    return _block_fwd("proj_fwd", x, k1, g1, b1, k2, g2, b2, (ks, gs, bs), stride, eps)


def proj_bwd(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, m1, v1, m2, v2, ms, vs, gout,
             stride, eps):
    """Projection BasicBlock backward (see :func:`proj_block_bwd_reference`);
    launches ``proj_bwd`` (or ``proj_bwd_bf16``) for CUDA tensors."""
    _admit_block(x, k1, stride, proj=True)
    if native.on_cpu(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, m1, v1, m2, v2, ms, vs, gout):
        return proj_block_bwd_reference(x, k1, g1, b1, k2, g2, b2, ks, gs, bs,
                                        m1, v1, m2, v2, ms, vs, gout, stride, eps)
    return _block_bwd("proj_bwd", x, k1, g1, b1, k2, g2, b2, (ks, gs, bs, ms, vs),
                      m1, v1, m2, v2, gout, stride, eps)


# ---------------------------------------------------------------------------
# Autograd functions and the public ops.
# ---------------------------------------------------------------------------


class FusedStem(torch.autograd.Function):
    """``(out, mean, var)`` of the fused stem; the backward is ``stem_bwd``.
    The kernel takes a copy of ``k`` in ``x``'s compute dtype; its gradient
    comes back widened to ``k``'s dtype."""

    @staticmethod
    def forward(ctx, x, k, g, b, eps):
        kc = k.to(x.dtype)
        out, m, v = stem_fwd(x, kc, g, b, eps)
        ctx.save_for_backward(x, kc, g, b, m, v)
        ctx.eps, ctx.w_dtype = eps, k.dtype
        ctx.mark_non_differentiable(m, v)
        return out, m, v

    @staticmethod
    def backward(ctx, gout, _gm, _gv):
        x, k, g, b, m, v = ctx.saved_tensors
        dx, dk, dg, db = stem_bwd(
            x, k, g, b, m, v, gout.contiguous(), ctx.eps, need_dx=ctx.needs_input_grad[0]
        )
        return dx, dk.to(ctx.w_dtype), dg, db, None


def _widen(grads, dtype, kernel_slots):
    """``grads`` with the entries at ``kernel_slots`` cast to ``dtype``."""
    return tuple(g.to(dtype) if i in kernel_slots and g is not None else g
                 for i, g in enumerate(grads))


class FusedBottleneck(torch.autograd.Function):
    """``(out, m1, v1, m2, v2, m3, v3[, mS, vS])`` of the fused Bottleneck;
    the backward is ``bottleneck_bwd``. ``ks, gs, bs`` are ``None`` for the
    identity shortcut. Kernels as in :class:`FusedStem`."""

    @staticmethod
    def forward(ctx, x, k1, g1, b1, k2, g2, b2, k3, g3, b3, ks, gs, bs, stride, eps):
        ctx.w_dtype = k1.dtype
        k1, k2, k3 = k1.to(x.dtype), k2.to(x.dtype), k3.to(x.dtype)
        ks = None if ks is None else ks.to(x.dtype)
        short = (ks, gs, bs) if ks is not None else None
        res = bottleneck_fwd(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short, stride, eps)
        moments = res[1:]
        ctx.save_for_backward(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, ks, gs, bs, *moments)
        ctx.stride, ctx.eps = stride, eps
        ctx.mark_non_differentiable(*moments)
        return res

    @staticmethod
    def backward(ctx, gout, *_moment_grads):
        saved = ctx.saved_tensors
        (x, k1, g1, b1, k2, g2, b2, k3, g3, b3, ks, gs, bs) = saved[:13]
        m1, v1, m2, v2, m3, v3 = saved[13:19]
        short = (ks, gs, bs) + tuple(saved[19:21]) if ks is not None else None
        grads = bottleneck_bwd(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, short,
                               m1, v1, m2, v2, m3, v3, gout.contiguous(),
                               ctx.stride, ctx.eps)
        if short is None:
            grads = grads + (None, None, None)
        return _widen(grads, ctx.w_dtype, (1, 4, 7, 10)) + (None, None)


class FusedBasicBlock(torch.autograd.Function):
    """``(out, m1, v1, m2, v2)`` of the fused identity BasicBlock; the
    backward is ``basic_bwd``. Kernels as in :class:`FusedStem`."""

    @staticmethod
    def forward(ctx, x, k1, g1, b1, k2, g2, b2, eps):
        ctx.w_dtype = k1.dtype
        k1, k2 = k1.to(x.dtype), k2.to(x.dtype)
        res = basic_fwd(x, k1, g1, b1, k2, g2, b2, eps)
        ctx.save_for_backward(x, k1, g1, b1, k2, g2, b2, *res[1:])
        ctx.eps = eps
        ctx.mark_non_differentiable(*res[1:])
        return res

    @staticmethod
    def backward(ctx, gout, *_moment_grads):
        x, k1, g1, b1, k2, g2, b2, m1, v1, m2, v2 = ctx.saved_tensors
        dx, dk1, dk2, dg1, db1, dg2, db2 = basic_bwd(
            x, k1, g1, b1, k2, g2, b2, m1, v1, m2, v2, gout.contiguous(), ctx.eps)
        return dx, dk1.to(ctx.w_dtype), dg1, db1, dk2.to(ctx.w_dtype), dg2, db2, None


class FusedProjectionBlock(torch.autograd.Function):
    """``(out, m1, v1, m2, v2, mS, vS)`` of the fused projection BasicBlock;
    the backward is ``proj_bwd``. Kernels as in :class:`FusedStem`."""

    @staticmethod
    def forward(ctx, x, k1, g1, b1, k2, g2, b2, ks, gs, bs, stride, eps):
        ctx.w_dtype = k1.dtype
        k1, k2, ks = k1.to(x.dtype), k2.to(x.dtype), ks.to(x.dtype)
        res = proj_fwd(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, stride, eps)
        ctx.save_for_backward(x, k1, g1, b1, k2, g2, b2, ks, gs, bs, *res[1:])
        ctx.stride, ctx.eps = stride, eps
        ctx.mark_non_differentiable(*res[1:])
        return res

    @staticmethod
    def backward(ctx, gout, *_moment_grads):
        dx, dk1, dk2, dks, dg1, db1, dg2, db2, dgs, dbs = proj_bwd(
            *ctx.saved_tensors, gout.contiguous(), ctx.stride, ctx.eps)
        w = ctx.w_dtype
        return (dx, dk1.to(w), dg1, db1, dk2.to(w), dg2, db2, dks.to(w), dgs, dbs,
                None, None)


def fused_conv_bn_relu(x, kernel, scale, bias, eps=1e-5):
    """Fused stem: ``relu(bn_train(conv3x3_s1(x, kernel)))``.

    ``x`` NHWC, ``kernel`` HWIO ``[3, 3, cin, cout]``; the compute dtype is
    ``x.dtype``. Returns ``(out, batch_mean, batch_var_biased)``; the
    caller applies the running-stat update. Gradients flow to all four
    inputs; the moments carry none.
    """
    return FusedStem.apply(
        x.contiguous(), kernel.contiguous(), scale.contiguous(), bias.contiguous(), float(eps)
    )


def fused_bottleneck_block(x, k1, g1, b1, k2, g2, b2, k3, g3, b3, shortcut=None, *,
                           stride: int = 1, eps: float = 1e-5):
    """Fused ResNet-50 Bottleneck, train mode.

    ``k1``/``k3`` are 1x1 kernels (``(1, 1, cin, P)``/``(1, 1, P, 4P)`` or
    2-D), ``k2`` the HWIO 3x3. ``shortcut`` is ``(k_sc, g_sc, b_sc)`` for
    projection sites (required exactly when ``stride != 1 or cin != 4P``),
    else ``None``. Returns ``(out, m1, v1, m2, v2, m3, v3[, m_sc, v_sc])``
    with biased variances; BN1 counts over the input grid, the others over
    the output grid.
    """
    cin, p = x.shape[3], k2.shape[2]
    if (stride != 1 or cin != 4 * p) != (shortcut is not None):
        raise ValueError("bottleneck shortcut params must be given exactly when "
                         "stride != 1 or in_channels != 4*planes")
    ks, gs, bs = shortcut if shortcut is not None else (None, None, None)
    c = lambda t: None if t is None else t.contiguous()  # noqa: E731
    return FusedBottleneck.apply(
        x.contiguous(), k1.reshape(cin, p).contiguous(), c(g1), c(b1), k2.contiguous(),
        c(g2), c(b2), k3.reshape(p, 4 * p).contiguous(), c(g3), c(b3),
        None if ks is None else ks.reshape(cin, 4 * p).contiguous(), c(gs), c(bs),
        int(stride), float(eps),
    )


def fused_basic_block(x, k1, g1, b1, k2, g2, b2, eps=1e-5):
    """Fused identity BasicBlock, train mode:
    ``relu(bn2(conv3x3(relu(bn1(conv3x3(x, k1))), k2)) + x)``.

    ``x`` NHWC ``[n, h, w, c]``, ``k1``/``k2`` HWIO ``[3, 3, c, c]``.
    Returns ``(out, m1, v1, m2, v2)`` with biased variances, both BNs over
    ``n * h * w``; the caller applies the running-stat updates.
    """
    c = lambda t: t.contiguous()  # noqa: E731
    return FusedBasicBlock.apply(c(x), c(k1), c(g1), c(b1), c(k2), c(g2), c(b2), float(eps))


def fused_projection_block(x, k1, g1, b1, k2, g2, b2, kernel_sc, scale_sc, bias_sc, *,
                           stride: int = 1, eps: float = 1e-5):
    """Fused projection-shortcut BasicBlock, train mode:
    ``relu(bn2(conv3x3(relu(bn1(conv3x3_s(x, k1))), k2)) + bn_sc(conv1x1_s(x, k_sc)))``.

    ``k1`` HWIO ``[3, 3, cin, c]``, ``k2`` ``[3, 3, c, c]``, ``kernel_sc``
    ``(1, 1, cin, c)`` or ``(cin, c)``. Returns ``(out, m1, v1, m2, v2,
    m_sc, v_sc)`` with biased variances, all three BNs over the OUTPUT grid.
    An identity geometry (stride 1, ``cin == c``) raises: that is
    :func:`fused_basic_block`'s.
    """
    cin, c = x.shape[3], k1.shape[3]
    if stride == 1 and cin == c:
        raise ValueError("projection block requires stride 2 or a channel change; "
                         "use fused_basic_block for identity-shortcut sites")
    t = lambda a: a.contiguous()  # noqa: E731
    return FusedProjectionBlock.apply(
        t(x), t(k1), t(g1), t(b1), t(k2), t(g2), t(b2), kernel_sc.reshape(cin, c).contiguous(),
        t(scale_sc), t(bias_sc), int(stride), float(eps),
    )
