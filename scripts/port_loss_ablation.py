"""Where the loss kernels' time goes, and the shapes ``chip_smoke.py`` skips.

    python3 scripts/port_loss_ablation.py [variant ...]

On one CUDA card:

- the committed kernels (``csrc/fused_supcon_loss.cu``) against their
  plain forms at the pins of ``PERF.md`` §2 at shapes beyond
  ``chip_smoke.LOSS_CASES``: D = 130 (4-byte loads, two 128-deep chunks),
  200 and 300 (two and three chunks, dF slabs), a 65-column block whose
  last split holds only the self column, a single anchor row, N = 8192
  (SimCLR, and SupCon rows 1000..2999), D = 64 and D = 4, and a feature
  matrix that starts 4 bytes past a 16-byte boundary; each bitwise
  repeatable;
- ablated builds: text edits of the committed source (``VARIANTS``; an
  edit whose text is gone raises), each built with the port's nvcc flags
  into ``build/loss_ablation/`` and bound through ctypes, timed by
  ``torch.profiler`` device time (mean over 50 calls at N = 512, 5 at
  N = 8192, the least of three traces) and by CUDA events, with their
  error against the plain forms (the ablations that skip work are wrong
  by design) and the ptxas registers and spills;
- the host time a call of the wrapper and of the bare ctypes call.

Prints one line per reading; exits non-zero without a card or when the
committed kernels break a pin.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.ops import fused_loss, native  # noqa: E402

SOURCE = os.path.join(REPO, "simclr_pytorch_distributed_tpu_torch", "csrc",
                      "fused_supcon_loss.cu")
OUT = os.path.join(REPO, "build", "loss_ablation")

# (case, batch, classes, dim, anchor rows, contrast columns), as LOSS_CASES
EXTRA_CASES = (
    ("D=130 4-byte loads, 2 chunks", 40, 3, 130, None, None),
    ("D=200 2 chunks", 37, None, 200, None, None),
    ("D=300 3 chunks, rows 10..59", 70, None, 300, (10, 60), None),
    ("65 columns, last split only the self column", 65, 3, 128, (0, 65), (0, 65)),
    ("one anchor row", 37, None, 128, (5, 6), None),
    ("N=8192", 4096, None, 128, None, None),
    ("N=8192 SupCon rows 1000..2999", 4096, 100, 128, (1000, 3000), None),
    ("D=64", 150, None, 64, None, None),
    ("D=4", 65, None, 4, None, None),
)

_STEPS = [("const int steps = t1 > t0 ? (t1 - t0) * g.nk : 0;", "const int steps = 0;"),
          ("const int steps = t1 > t0 ? (t1 - t0) * per_tile : 0;", "const int steps = 0;")]
_COMBINE = [("  cluster_wait();\n", ""), ("cluster.sync();", "__syncthreads();"),
            ("*cluster.map_shared_rank(&inbox[split][lr % (BM / S)], lr / (BM / S))",
             "inbox[split][lr % (BM / S)]"),
            ("cluster.map_shared_rank(reinterpret_cast<float4*>(inbox), dd / SL)",
             "reinterpret_cast<float4*>(inbox)")]
_FMAS = [("  for (int k = k0; k < k1; k += 4) {", "  for (int k = k0; k < k0; k += 4) {"),
         ("&& dd < kw_slab) {", "&& dd < 0) {")]
_LOOP_LOADS = """  for (int k = k0; k < k1; k += 4) {
    float4 a[TR], b[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      a[i] = *reinterpret_cast<const float4*>(rows + (ty + 8 * i) * ldk + k);
#pragma unroll
    for (int j = 0; j < TC; ++j)
      b[j] = *reinterpret_cast<const float4*>(cols + (tx + 16 * j) * ldk + k);"""
_LOOP_FMAS = """      for (int j = 0; j < TC; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }"""
# name -> (what it measures, text edits)
VARIANTS = {
    "base": ("the committed kernels", []),
    "no_walk": ("no column tile walked: launch, row ids and the combine", _STEPS),
    "no_combine": ("no cluster barrier or push: each split writes its own partials",
                   _COMBINE),
    "no_fmas": ("tiles loaded and waited for, no logits or h @ F FMAs", _FMAS),
    "fmas_only": ("the logits loop's operands read once, its FMAs kept", [(_LOOP_LOADS, """\
  float4 a[TR], b[TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
    a[i] = *reinterpret_cast<const float4*>(rows + (ty + 8 * i) * ldk + k0);
#pragma unroll
  for (int j = 0; j < TC; ++j)
    b[j] = *reinterpret_cast<const float4*>(cols + (tx + 16 * j) * ldk + k0);
  for (int k = k0; k < k1; k += 4) {""")]),
    "reads_only": ("the logits loop's shared-memory reads kept, a quarter of its FMAs",
                   [(_LOOP_FMAS, """      for (int j = 0; j < TC; ++j)
        acc[i][j] = fmaf((a[i].x + a[i].y) + (a[i].z + a[i].w),
                         (b[j].x + b[j].y) + (b[j].z + b[j].w), acc[i][j]);""")]),
    "s4": ("clusters of 4 splits", [("constexpr int S = 8; ", "constexpr int S = 4; ")]),
    "one_cta_an_sm": ("registers not held to two CTAs an SM",
                      [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")]),
}


def edited(name):
    text = open(SOURCE).read()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise KeyError(f"variant {name}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name):
    """``(name, library path, ptxas register and spill lines)``."""
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
    with open(src, "w") as fh:
        fh.write(edited(name))
    proc = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    return name, lib, [line.strip() for line in log if "registers" in line or "spill" in line]


def bind(path):
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.supcon_fwd.argtypes = [p] * 9 + [i, i, i, f, f, p]
    lib.supcon_bwd.argtypes = [p] * 11 + [i, i, i, f, f, p]
    return lib


def raw_calls(lib, n, dev):
    """Bare ctypes calls of ``lib``'s two entry points at N = ``n``, their
    outputs, and the plain forms' on the same inputs."""
    f, ids, gid = cs.loss_inputs(n // 2, seed=2, device=dev)
    args = (f, f, ids, ids, gid, gid)
    ref = fused_loss.fused_rows_reference(*args, cs.TEMP, cs.BASE_TEMP)
    _, lse, cnt = ref
    coeff = (cs.TEMP / cs.BASE_TEMP) / n
    dref = fused_loss.fused_bwd_reference(*args, lse, lse, cnt, cnt, cs.TEMP, coeff)
    outs = torch.empty((3, n), device=dev)
    dfeat = torch.empty((n, cs.DIM), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in args]

    def fwd():
        native.raise_on_error(lib.supcon_fwd(
            *ptrs, *(outs[k].data_ptr() for k in range(3)), n, n, cs.DIM, 1 / cs.TEMP,
            cs.TEMP / cs.BASE_TEMP, stream), "supcon_fwd_kernel")

    def bwd():
        native.raise_on_error(lib.supcon_bwd(
            *ptrs, lse.data_ptr(), lse.data_ptr(), cnt.data_ptr(), cnt.data_ptr(),
            dfeat.data_ptr(), n, n, cs.DIM, 1 / cs.TEMP, coeff, stream), "supcon_bwd_kernel")
    return fwd, bwd, outs, dfeat, ref, dref


def device_us(fn, calls):
    """Mean profiler device time of the loss kernels over ``calls`` calls,
    the least of three traces."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(a, "self_device_time_total", 0.0) for a in prof.key_averages()
                 if "supcon" in a.key) / calls
        best = us if best is None else min(best, us)
    return best


def committed_checks(dev):
    """The committed kernels at ``EXTRA_CASES`` and at a misaligned
    feature pointer: the pins, and two calls bitwise equal."""
    cs.LOSS_CASES = EXTRA_CASES
    cs.loss_parity(fused_loss, dev)
    for case in EXTRA_CASES:
        args, bwd_args = cs.loss_case(fused_loss, dev, *case[1:])
        for what, call in (("fwd", lambda: fused_loss.fused_rows(*args, cs.TEMP, cs.BASE_TEMP)),
                           ("bwd", lambda: (fused_loss.fused_bwd(*bwd_args),))):
            if not all(torch.equal(a, b) for a, b in zip(call(), call())):
                raise AssertionError(f"{case[0]} {what}: two calls differ")
    print(f"determinism: forward and backward bitwise repeatable at all {len(EXTRA_CASES)} cases")
    f, ids, gid = cs.loss_inputs(100, seed=3, device=dev)
    shifted = torch.empty(f.numel() + 1, device=dev)[1:].view(f.shape)
    shifted.copy_(f)
    args = (shifted, shifted, ids, ids, gid, gid)
    got = fused_loss.fused_rows(*args, cs.TEMP, cs.BASE_TEMP)
    ref = fused_loss.fused_rows_reference(*args, cs.TEMP, cs.BASE_TEMP)
    bwd_args = args + (ref[1], ref[1], ref[2], ref[2], cs.TEMP, 0.01)
    d_got, d_ref = fused_loss.fused_bwd(*bwd_args), fused_loss.fused_bwd_reference(*bwd_args)
    rel = [((g - r).abs() / r.abs()).max().item() for g, r in zip(got[:2], ref[:2])]
    d_err = ((d_got - d_ref).abs().max() / d_ref.abs().max()).item()
    print(f"features at {shifted.data_ptr() % 16} bytes past a 16-byte boundary: loss_row rel "
          f"{rel[0]:.3e}, lse rel {rel[1]:.3e}, cnt equal {torch.equal(got[2], ref[2])}, dF "
          f"{d_err:.3e} of max|dF|")
    if not (max(rel) <= 1e-5 and torch.equal(got[2], ref[2]) and d_err <= 1e-5):
        raise AssertionError("the misaligned case breaks a pin")


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("port_loss_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    where = f"on {cs.card_line()}"
    committed_checks(dev)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    for name, path, ptxas in built:
        print(f"variant {name} ({VARIANTS[name][0]}): " + "; ".join(ptxas))
        lib = bind(path)
        for n, calls in ((512, 50), (8192, 5)):
            fwd, bwd, outs, dfeat, ref, dref = raw_calls(lib, n, dev)
            fwd()
            bwd()
            torch.cuda.synchronize()
            errs = [((outs[k] - ref[k]).abs() / ref[k].abs()).max().item() for k in range(3)]
            d_err = ((dfeat - dref).abs().max() / dref.abs().max()).item()
            print(f"variant {name} N={n}: device fwd {device_us(fwd, calls):.2f} us, bwd "
                  f"{device_us(bwd, calls):.2f} us (mean of {calls}); CUDA events fwd "
                  f"{cs.cuda_time_ms(fwd) * 1e3:.2f} us, bwd {cs.cuda_time_ms(bwd) * 1e3:.2f} us; "
                  f"error loss_row {errs[0]:.1e} lse {errs[1]:.1e} cnt {errs[2]:.1e} dF "
                  f"{d_err:.1e} {where}", flush=True)
            del fwd, bwd, outs, dfeat, ref, dref
            torch.cuda.empty_cache()
    fwd, bwd, *_ = raw_calls(bind(built[0][1]), 512, dev)
    f, ids, gid = cs.loss_inputs(256, seed=2, device=dev)
    args = (f, f, ids, ids, gid, gid)
    wrapper = cs.host_ms_per_call(lambda: fused_loss.fused_rows(*args, cs.TEMP, cs.BASE_TEMP))
    print(f"host time a call at N=512 ({built[0][0]}): wrapper fused_rows "
          f"{wrapper * 1e3:.2f} us, bare ctypes fwd {cs.host_ms_per_call(fwd) * 1e3:.2f} us, "
          f"bwd {cs.host_ms_per_call(bwd) * 1e3:.2f} us {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
