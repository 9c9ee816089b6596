// Fused conv + train-mode BatchNorm (+ ReLU, + residual) for the CIFAR
// ResNet stem, the ResNet-18/34 BasicBlocks and the ResNet-50 Bottleneck,
// forward and backward, for Hopper (sm_90a), with a plain C interface bound
// through ctypes (ops/native.py builds this file, ops/fused_conv.py wraps
// it).
//
// What each entry point replaces, in
// simclr_pytorch_distributed_tpu/ops/pallas_conv.py:
//   stem_fwd        <- _stem_fwd_kernel :401 (reached through _stem_call :492)
//   stem_bwd        <- _stem_bwd_kernel :443 (_stem_bwd_call :527)
//   basic_fwd       <- _block_fwd_kernel :639 (_block_call :788)
//   basic_bwd       <- _block_bwd_kernel :705 (_block_bwd_call :817)
//   proj_fwd        <- _proj_fwd_kernel :930 (_proj_call :1108)
//   proj_bwd        <- _proj_bwd_kernel :1006 (_proj_bwd_call :1144)
//   bottleneck_fwd  <- _bot_fwd_kernel :1289 (_bot_call :1565)
//   bottleneck_bwd  <- _bot_bwd_kernel :1408 (_bot_bwd_call :1627)
//
// Semantics are the Pallas ops': NHWC activations, HWIO 3x3 kernels and
// [Cin, Cout] 1x1 kernels, fp32 throughout. Train-mode BN normalizes with
// the batch mean and the biased batch variance; the entry points return
// those moments and never touch running statistics. The backward is the
// standard train-mode BN backward (dbeta = sum dp, dgamma = sum dp * yhat,
// dy = rstd * gamma * (dp - dbeta / n - yhat * dgamma / n)), with the
// moments treated as ancillary outputs whose cotangents are dropped.
// Bottleneck: BN1 counts over the input grid, BN2/BN3/shortcut BN over the
// output grid; the shortcut BN's bias gradient is the same sum of dz as
// BN3's (both biases add straight into z). BasicBlocks: every BN counts
// over the output grid, BN1 of the projection block included (its strided
// 3x3 comes first), and the shortcut BN's bias gradient is BN2's. Every
// block entry point (Bottleneck and BasicBlock, forward and backward) runs
// on the pipelined core (below); the stem runs two passes of its own that
// recompute its conv (its section, near the end of the file).
//
// Design: phases become kernels. The Pallas kernels walk a sequential
// phase-major grid (phases, batch tiles) and carry BN sums from tile to
// tile in VMEM scratch. CTAs on Hopper run in no order, so each entry point
// is a sequence of kernels on the caller's stream. Every entry point
// shares these:
//   - the statistics partials: per 128-row tile and channel, the tile mean
//     and centred sum of squares, [tiles, C] (the core's statistics
//     epilogue, the stem's first pass);
//   - bn_finalize_kernel: combines the partials in a fixed order, in fp64,
//     around a per-channel shift (the first tile's mean), so the variance
//     suffers no E[y^2] - E[y]^2 cancellation and repeated runs are
//     bitwise identical; then folds gamma/beta into scale/shift;
//   - split_reduce_kernel: the fixed-order fp64 combine of weight-gradient
//     partials, rounded once;
//   - bn_bwd_sums_kernel + sum_partials_kernel, bn_bwd_apply_kernel: the
//     elementwise BN backward and its per-channel sums.
// There are no atomics anywhere, so every output is deterministic.
//
// The Bottleneck entry points (bottleneck_fwd, bottleneck_bwd) and the
// BasicBlock ones (basic_fwd, basic_bwd, proj_fwd, proj_bwd), fp32 and
// bf16, are redesigned around the pipelined GEMM core of
// conv_gemm_sm90.cuh, which runs every one of their convolutions:
// conv_gemm_f32_kernel / conv_wgrad_f32_kernel (fp32) and
// conv_gemm_sm90_kernel / conv_wgrad_sm90_kernel (bf16, wgmma). Under the
// first design the two Bottleneck entry points took 96% of the fp32
// ResNet-50 step and 88% of the bf16 one (PERF.md), and lost their time
// to (1) GEMMs without pipelining, with a BN+ReLU prologue in every
// loader, (2) a transposed stride-2 gather that multiplies the zeros of
// the dilated gradient, and (3) fp32 cotangents and scalar fp32 passes
// over the 4P-wide tensors. The
// backwards' schedule (the Bottleneck's; block_bwd runs it with the
// BasicBlock's convs, its stage 2 being the Bottleneck's stage 3) answers
// each:
//   - plain operands: the recomputed convs' epilogues write y (fp32, for
//     the BN backward's yhat and masks) and the next conv's operand a =
//     rnd(relu(y * scale + shift)) in the compute dtype, the value the
//     prologue computed from the same y and rounded at the same point;
//     every cotangent is written once, in the compute dtype, by the pass
//     that forms it (each GEMM that reads it rounded it there before).
//     So every GEMM operand is a plain tensor that cp.async copies;
//   - the stride-2 data gradients by parity: the transposed 3x3/s2 runs as
//     four sub-GEMMs (one per parity class of the input grid, 1, 2, 2 and
//     4 taps), the transposed 1x1/s2 of the shortcut as the even-even
//     class only, whose dx epilogue adds it (a BasicBlock's transposed
//     3x3/s2 adds it in class (0, 0) alone); no zero is multiplied;
//   - stage 3 in two passes: bot_dz_sums_kernel forms z in registers,
//     writes dz = gout (z > 0) in the compute dtype and the per-CTA
//     partial sums; bot_dz_apply_kernel writes dy3 (and dyS). z is never
//     stored; the identity block's dx epilogue takes dz as its residual.
//     Four channels a thread, or one where C % 4 != 0 (a BasicBlock's C
//     may be any count).
// The forwards cannot fold their BNs into the epilogues that way: the scale
// and shift come from this batch's statistics, known only once the whole
// conv has run. So each conv writes y in fp32 through the core's
// statistics epilogue (per-CTA tile mean and centred sum of squares, the
// partials bn_finalize_kernel combines), bn_finalize_kernel folds the BN,
// and one 4-wide pass, bn_act_kernel, writes a = rnd(relu(y * scale +
// shift)) in the compute dtype as a plain tensor (over y under fp32):
//   y1 = x k1 (stats), finalize, a1;  y2 = conv3x3/s(a1, k2) (stats),
//   finalize, a2;  y3 = a2 k3 (stats), finalize;  yS = x ks /s (stats),
//   finalize (projection);  out = rnd(relu(y3 s3 + t3 + (yS sS + tS | x)))
//   in one 4-wide pass, bot_out_kernel. block_fwd runs the same schedule
//   with the BasicBlock's convs: y1 = conv3x3/s(x, k1), a1, y2 =
//   conv3x3(a1, k2), yS = conv1x1/s(x, ks), and the last pass over y2,
//   four channels a thread where C % 4 == 0, else one.
// A materialised a, not the prologue in the loader, keeps every operand a
// plain tensor for 16-byte cp.async, keeps the bf16 ring's stages bf16 (an
// fp32 y would not fit them), and keeps the 3x3's zero padding zero after
// the activation (the Pallas _fill_pad), which a loader that transforms
// what it loads would have to special-case (relu(0 * s + t) != 0). The
// act pass forms a as the backward's act epilogue does (one fmaf), so the
// forward's a1/a2 equal the backward's recomputed ones bitwise. The stem
// alone recomputes its conv in every pass instead (its section says why).

// Stage, not recompute, inside a call: a call keeps its pre-BN
// intermediates (y1, y2, y3, yS) in a workspace the wrapper allocates with
// torch.empty and frees on return. Across forward -> backward the op's
// contract is the Pallas one: only x, the weights and the O(C) moments are
// saved, so the backward recomputes the forward convolutions once (one
// extra forward's FLOPs) and then stages its own intermediates. The Pallas
// kernels recompute every conv in every phase because VMEM cannot hold a
// batch of activations; HBM can, and re-running a block's conv costs far
// more than writing and reading its output once. The stem's conv is the
// exception (1.8 GFLOP against 134 MB of y): it recomputes, as Pallas does.
//
// What bounds it on the H100. Fp32 FMA on the CUDA cores (no TF32, no
// tensor cores, no fast-math), so the fp32 convolutions are bound by the
// 67 TFLOP/s non-tensor fp32 rate: a recipe-shape Bottleneck forward is
// ~83 GFLOP against ~3 GB of activations, a recipe-shape ResNet-18 block
// 60-77 GFLOP. The stem and the elementwise BN passes are bound by bytes.
// The core's fp32 kernels take 128 x 128 tiles, 8 x 8 micro-tiles fed by
// 16-byte shared loads and a three-stage cp.async ring. Each BN pass is one
// read and one write of its tensor.
//
// Shared memory is dynamic (the core's 43-55 KB fp32 and 96-128 KB bf16,
// the stem's 63-70 KB; set with cudaFuncSetAttribute) and independent of
// the geometry, so the Hopper admission gate
// (ops/fused_conv.py supports_*) needs only the geometric rules and the
// 32-bit row-index range.
//
// bf16 compute (the *_bf16 entry points, the Pallas kernels run with a
// bf16 compute dtype). x, the kernels, the upstream gradient, out, dx and
// every dW are bf16; the moments, gamma/beta and their gradients stay
// fp32. Every convolution rounds its operands to bf16 and multiplies them
// on the tensor cores with fp32 accumulation: mma.sync m16n8k16 in the
// stem's passes, wgmma on the core in every block entry point. The
// rounding points
// are the Pallas kernels': the BN+ReLU of a staged y runs in fp32 on the
// fp32 y and rounds its result (the _fill_pad cast), a cotangent is
// rounded where it enters a product (as the Pallas backward casts dy
// before each transposed product and each dW accumulation), and the
// pre-BN y, the BN statistics, the residual adds and every BN backward
// stay fp32 (the Pallas kernels never round them). dW is rounded once,
// after the fp64 combine of its fp32 partials. The staged buffers are the
// fp32 path's, plus fp32 buffers where that path stages in place in an
// output that is bf16 here (y of the last conv, and the shortcut's share
// of the projection blocks' dx), plus the redesigned entry points'
// compute-dtype operands and cotangents. The elementwise kernels are
// templates over the types they read and write; their fp32 instances are
// the fp32 path's code. Each *_bf16 entry point replaces the same Pallas
// kernel as its fp32 twin, run with a bf16 compute dtype. What bounds
// them: the convolutions by operations at the dense bf16 tensor-core rate
// (989 TFLOP/s: a recipe-shape Bottleneck forward in ~0.1 ms), the BN
// passes and the stem by bytes: the core answers the first with wgmma on a
// three-stage cp.async ring, the second with two-byte operands and
// cotangents, a pass fewer in the backward and 4-wide passes (PERF.md has
// the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "conv_gemm_sm90.cuh"

namespace {

constexpr int THREADS = 256;
// rows of a statistics tile: bn_finalize_kernel counts min(BM, rows - t *
// BM) rows in tile t, for the pipelined core's statistics epilogue and for
// the stem's first pass
constexpr int BM = 128;
static_assert(sm90::GEMM_BM == BM, "one tile height for every statistics partial");
// rows per CTA of the per-channel elementwise kernels (block 32 x 8)
constexpr int EW_ROWS = 128;

using bf16 = __nv_bfloat16;

using sm90::from_f;  // float -> float or bf16 (round to nearest)
using sm90::to_f;    // float or bf16 -> float

// out[i] = sum over z of part[z, i], in order, in fp64, rounded once to OutT.
template <typename OutT>
__global__ void split_reduce_kernel(const float* __restrict__ part, int splits,
                                    long long count, OutT* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int z = 0; z < splits; ++z) s += part[z * count + i];
    out[i] = from_f<OutT>((float)s);
  }
}

__device__ __forceinline__ void fold(float m, float v, float gamma, float beta,
                                     float eps, float& rs, float& sc,
                                     float& sh) {
  rs = 1.0f / sqrtf(v + eps);
  sc = gamma * rs;
  sh = beta - m * sc;
}

// Batch moments from the statistics tile partials (tile t holds
// min(BM, rows - t * BM) rows), combined around the shift K = the first
// tile's mean:  sum (y - K) = sum_t n_t (mean_t - K),
// sum (y - K)^2 = sum_t [m2_t + n_t (mean_t - K)^2],  in fp64 and in a
// fixed order. Block (32 channels x 32 lanes).
__global__ void bn_finalize_kernel(const float* __restrict__ pm,
                                   const float* __restrict__ pq, int tiles,
                                   int rows, int C,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float eps,
                                   float* __restrict__ mean,
                                   float* __restrict__ var,
                                   float* __restrict__ rstd,
                                   float* __restrict__ scale,
                                   float* __restrict__ shift) {
  __shared__ double s1[32][33], s2[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  double a = 0.0, b = 0.0, shiftk = 0.0;
  if (c < C) {
    shiftk = pm[c];
    for (int t = ty; t < tiles; t += 32) {
      const double nb = (double)min(BM, rows - t * BM);
      const double d = (double)pm[(size_t)t * C + c] - shiftk;
      a += nb * d;
      b += (double)pq[(size_t)t * C + c] + nb * d * d;
    }
  }
  s1[ty][tx] = a;
  s2[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    double sa = 0.0, sb = 0.0;
    for (int t = 0; t < 32; ++t) {
      sa += s1[t][tx];
      sb += s2[t][tx];
    }
    const double mu = sa / rows;
    double v = sb / rows - mu * mu;
    if (v < 0.0) v = 0.0;
    const float mf = (float)(shiftk + mu), vf = (float)v;
    mean[c] = mf;
    var[c] = vf;
    float rs, sc, sh;
    fold(mf, vf, gamma[c], beta[c], eps, rs, sc, sh);
    rstd[c] = rs;
    scale[c] = sc;
    shift[c] = sh;
  }
}

// rstd / scale / shift from saved moments (the backward's recompute).
__global__ void bn_fold_kernel(const float* __restrict__ mean,
                               const float* __restrict__ var,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, float eps,
                               int C, float* __restrict__ rstd,
                               float* __restrict__ scale,
                               float* __restrict__ shift) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float rs, sc, sh;
  fold(mean[c], var[c], gamma[c], beta[c], eps, rs, sc, sh);
  rstd[c] = rs;
  scale[c] = sc;
  shift[c] = sh;
}

// dp = g where the ReLU passed (mask > 0, or yhat * gamma + beta > 0 when
// mask is null), else 0; per-CTA partial sums of dp and dp * yhat with
// yhat = (y - mean) * rstd. dp_out (may be null) may alias g.
// Block (32 channels x 8 row lanes), EW_ROWS rows per CTA. g is the
// upstream gradient (GT bf16 under bf16 compute) or an fp32 staged one.
template <typename GT>
__global__ void bn_bwd_sums_kernel(const GT* g, const float* mask,
                                   const float* __restrict__ y,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ rstd,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* dp_out,
                                   float* __restrict__ part_a,
                                   float* __restrict__ part_b, int M, int C) {
  __shared__ float ra[8][33], rb[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * 32 + tx;
  float sa = 0.f, sb = 0.f;
  if (c < C) {
    const float mu = mean[c], rs = rstd[c];
    const float ga = gamma ? gamma[c] : 0.f, be = beta ? beta[c] : 0.f;
    const int r0 = blockIdx.x * EW_ROWS;
    for (int r = ty; r < EW_ROWS; r += 8) {
      const int row = r0 + r;
      if (row >= M) break;
      const size_t i = (size_t)row * C + c;
      const float yh = (y[i] - mu) * rs;
      const bool on = mask ? mask[i] > 0.f : fmaf(yh, ga, be) > 0.f;
      const float dp = on ? to_f(g[i]) : 0.f;
      if (dp_out) dp_out[i] = dp;
      sa += dp;
      sb = fmaf(dp, yh, sb);
    }
  }
  ra[ty][tx] = sa;
  rb[ty][tx] = sb;
  __syncthreads();
  if (ty == 0 && c < C) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < 8; ++t) {
      a += ra[t][tx];
      b += rb[t][tx];
    }
    part_a[(size_t)blockIdx.x * C + c] = a;
    part_b[(size_t)blockIdx.x * C + c] = b;
  }
}

// out_a[c] = sum_t pa[t, c], out_b[c] = sum_t pb[t, c]: fp64, fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ pa,
                                    const float* __restrict__ pb, int blocks,
                                    int C, float* __restrict__ out_a,
                                    float* __restrict__ out_b) {
  __shared__ double s1[32][33], s2[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int t = ty; t < blocks; t += 32) {
      a += pa[(size_t)t * C + c];
      b += pb[(size_t)t * C + c];
    }
  }
  s1[ty][tx] = a;
  s2[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    double sa = 0.0, sb = 0.0;
    for (int t = 0; t < 32; ++t) {
      sa += s1[t][tx];
      sb += s2[t][tx];
    }
    out_a[c] = (float)sa;
    out_b[c] = (float)sb;
  }
}

// dy = rstd * gamma * (dp - sum_dp / count - yhat * sum_dpyh / count),
// stored as OutT (the compute dtype where dy only feeds GEMMs, which
// round it there anyway); an fp32 dy may alias dp or y.
template <typename OutT>
__global__ void bn_bwd_apply_kernel(const float* dp, const float* y,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ rstd,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ sum_dp,
                                    const float* __restrict__ sum_dpyh,
                                    float count, OutT* dy, long long total,
                                    int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const float rs = rstd[c];
    const float yh = (y[i] - mean[c]) * rs;
    dy[i] = from_f<OutT>(rs * gamma[c] *
                         (dp[i] - sum_dp[c] / count - yh * sum_dpyh[c] / count));
  }
}

// W consecutive elements at p as floats, and back (one 16- or 8-byte access
// at W = 4, which then lies inside one row of a C % 4 == 0 tensor).
template <int W, typename T>
__device__ __forceinline__ void load_w(const T* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = sm90::load4(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = to_f(p[e]);
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_w(T* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    sm90::store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) p[e] = from_f<T>(v[e]);
  }
}

// The BN backward of a residual block's last BN (the Bottleneck's BN3, a
// BasicBlock's BN2; y3 below) and of its shortcut BN, pass 1: z = y3 * sc3
// + sh3 plus the shortcut (ys * scs + shs for the projection, else x),
// formed in registers exactly as the forward's last pass (bot_out_kernel)
// forms it and never stored; dz = gout where z > 0, else 0, written in the
// compute dtype (exact: gout is in it and the mask is 0/1); per-CTA
// partials of sum dz, sum dz * yhat3 and (projection) sum dz * yhatS.
// Block (32 x 8): lane tx
// takes channels W tx .. W tx + W - 1 of the CTA's 32 W (W = 4 needs C % 4
// == 0, W = 1 takes any C), each of the 8 row lanes every eighth of the
// CTA's EW_ROWS rows.
template <typename T, int W>
__global__ void bot_dz_sums_kernel(const float* __restrict__ y3, const float* __restrict__ sc3,
                                   const float* __restrict__ sh3, const float* __restrict__ m3,
                                   const float* __restrict__ rs3, const float* __restrict__ ys,
                                   const float* __restrict__ scs, const float* __restrict__ shs,
                                   const float* __restrict__ ms, const float* __restrict__ rss,
                                   const T* __restrict__ x, const T* __restrict__ g,
                                   T* __restrict__ dz, float* __restrict__ part_a,
                                   float* __restrict__ part_b, float* __restrict__ part_c,
                                   int M, int C) {
  constexpr int CPB = 32 * W;  // channels a CTA
  __shared__ float ra[8][CPB + 1], rb[8][CPB + 1], rc[8][CPB + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.y * CPB + tx * W;
  float sa[W], sb[W], sq[W];
#pragma unroll
  for (int e = 0; e < W; ++e) sa[e] = sb[e] = sq[e] = 0.f;
  if (c0 < C) {
    float a3[W], b3[W], mu3[W], r3[W], aS[W], bS[W], muS[W], rS[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      a3[e] = sc3[c0 + e]; b3[e] = sh3[c0 + e]; mu3[e] = m3[c0 + e]; r3[e] = rs3[c0 + e];
      aS[e] = ys ? scs[c0 + e] : 0.f; bS[e] = ys ? shs[c0 + e] : 0.f;
      muS[e] = ys ? ms[c0 + e] : 0.f; rS[e] = ys ? rss[c0 + e] : 0.f;
    }
    const int r0 = blockIdx.x * EW_ROWS;
    for (int r = ty; r < EW_ROWS; r += 8) {
      const int row = r0 + r;
      if (row >= M) break;
      const size_t i = (size_t)row * C + c0;
      float yv[W], sv[W], gv[W], dv[W];
      load_w<W>(y3 + i, yv);
      if (ys)
        load_w<W>(ys + i, sv);
      else
        load_w<W>(x + i, sv);
      load_w<W>(g + i, gv);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float v = fmaf(yv[e], a3[e], b3[e]);
        v += ys ? fmaf(sv[e], aS[e], bS[e]) : sv[e];
        const float dp = fmaxf(v, 0.f) > 0.f ? gv[e] : 0.f;
        dv[e] = dp;
        sa[e] += dp;
        sb[e] = fmaf(dp, (yv[e] - mu3[e]) * r3[e], sb[e]);
        if (ys) sq[e] = fmaf(dp, (sv[e] - muS[e]) * rS[e], sq[e]);
      }
      store_w<W>(dz + i, dv);
    }
  }
#pragma unroll
  for (int e = 0; e < W; ++e) {
    ra[ty][tx * W + e] = sa[e];
    rb[ty][tx * W + e] = sb[e];
    rc[ty][tx * W + e] = sq[e];
  }
  __syncthreads();
  const int t = ty * 32 + tx;  // one channel of the CTA's CPB a thread
  const int c = blockIdx.y * CPB + t;
  if (t < CPB && c < C) {
    float a = 0.f, b = 0.f, q = 0.f;
    for (int k = 0; k < 8; ++k) {
      a += ra[k][t];
      b += rb[k][t];
      q += rc[k][t];
    }
    part_a[(size_t)blockIdx.x * C + c] = a;
    part_b[(size_t)blockIdx.x * C + c] = b;
    if (ys) part_c[(size_t)blockIdx.x * C + c] = q;
  }
}

// Pass 2: dy3 (and, for the projection, dyS) in the compute dtype from dz
// and the finalized sums, as bn_bwd_apply_kernel computes them (the
// shortcut BN's sum dz is BN3's); W consecutive elements a thread (W = 4
// needs C % 4 == 0).
template <typename T, int W>
__global__ void bot_dz_apply_kernel(const T* __restrict__ dz, const float* __restrict__ y3,
                                    const float* __restrict__ m3, const float* __restrict__ rs3,
                                    const float* __restrict__ g3, const float* __restrict__ db3,
                                    const float* __restrict__ dg3, const float* __restrict__ ys,
                                    const float* __restrict__ ms, const float* __restrict__ rss,
                                    const float* __restrict__ gs, const float* __restrict__ dgs,
                                    float count, T* dy3, T* dys, long long total, int C) {
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * W; i < total;
       i += (long long)gridDim.x * blockDim.x * W) {
    const int c0 = (int)(i % C);
    float dp[W], yv[W], out[W];
    load_w<W>(dz + i, dp);
    load_w<W>(y3 + i, yv);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int c = c0 + e;
      const float r3 = rs3[c];
      const float yh = (yv[e] - m3[c]) * r3;
      out[e] = r3 * g3[c] * (dp[e] - db3[c] / count - yh * dg3[c] / count);
    }
    store_w<W>(dy3 + i, out);
    if (ys) {
      float sv[W];
      load_w<W>(ys + i, sv);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int c = c0 + e;
        const float rS = rss[c];
        const float yhs = (sv[e] - ms[c]) * rS;
        out[e] = rS * gs[c] * (dp[e] - db3[c] / count - yhs * dgs[c] / count);
      }
      store_w<W>(dys + i, out);
    }
  }
}

// a = rnd(relu(y * sc + sh)) in the compute dtype, formed as the pipelined
// core's act epilogue forms it (store_one: one fmaf, then the ReLU), so the
// forward's a equals the backward's recomputed a bitwise. Four consecutive
// elements of the flat [rows, C] tensor a thread, the channel counted
// along; the last partial group one at a time. a may alias y (fp32).
template <typename T>
__global__ void bn_act_kernel(const float* y, const float* __restrict__ sc,
                              const float* __restrict__ sh, T* a, long long total, int C) {
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4; i < total;
       i += (long long)gridDim.x * blockDim.x * 4) {
    int c = (int)(i % C);
    if (i + 4 <= total) {
      const float4 y4 = sm90::load4(y + i);
      float v[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = fmaxf(fmaf(v[e], sc[c], sh[c]), 0.f);
        c = c + 1 == C ? 0 : c + 1;
      }
      sm90::store4(a + i, make_float4(v[0], v[1], v[2], v[3]));
    } else {
      for (long long j = i; j < total; ++j) {
        a[j] = from_f<T>(fmaxf(fmaf(y[j], sc[c], sh[c]), 0.f));
        c = c + 1 == C ? 0 : c + 1;
      }
    }
  }
}

// A residual block's last pass (the Bottleneck's and the BasicBlock's
// forward): out = rnd(relu(y3 * sc3 + sh3 + (ys * scs + shs | x))), y3 the
// last conv's pre-BN output, z formed as bot_dz_sums_kernel forms it. W
// consecutive elements a thread, all of one row: W = 4 needs C % 4 == 0
// (the Bottleneck's C = 4P always, a BasicBlock's C where it holds), W = 1
// takes any C (a BasicBlock's C may be any count); the host picks W as
// residual_bn_bwd does. out may alias y3 (fp32).
template <typename T, int W>
__global__ void bot_out_kernel(const float* y3, const float* __restrict__ sc3,
                               const float* __restrict__ sh3, const float* __restrict__ ys,
                               const float* __restrict__ scs, const float* __restrict__ shs,
                               const T* __restrict__ x, T* out, long long total, int C) {
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * W; i < total;
       i += (long long)gridDim.x * blockDim.x * W) {
    const int c0 = (int)(i % C);
    float yv[W], sv[W], v[W];
    load_w<W>(y3 + i, yv);
    if (ys)
      load_w<W>(ys + i, sv);
    else
      load_w<W>(x + i, sv);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int c = c0 + e;
      v[e] = fmaf(yv[e], sc3[c], sh3[c]);
      v[e] += ys ? fmaf(sv[e], scs[c], shs[c]) : sv[e];
      v[e] = fmaxf(v[e], 0.f);
    }
    store_w<W>(out + i, v);
  }
}

// ---------------------------------------------------------------------------
// Host side: workspace carving and the launch sequences.
// ---------------------------------------------------------------------------

#define CHECK(expr)                                 \
  do {                                              \
    const cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return e_;                   \
  } while (0)

// Carves 256-byte aligned float buffers out of one workspace. With a null
// base it only counts, so the same code sizes the workspace and uses it.
struct Arena {
  char* base;
  size_t off = 0;
  float* take(size_t count) {
    float* p = base ? reinterpret_cast<float*>(base + off) : nullptr;
    off += (count * sizeof(float) + 255) & ~size_t(255);
    return p;
  }
};

// Where a sequence stages an fp32 tensor that ends in the output `out`:
// in out itself under fp32 compute (normalized or summed in place), in a
// workspace buffer of its own under bf16 compute (out is bf16 there).
template <typename T>
float* staged(Arena& ar, T* out, size_t count) {
  if constexpr (std::is_same<T, float>::value)
    return out;
  else
    return ar.take(count);
}

constexpr const float* kNone = nullptr;  // an absent fp32 operand

using sm90::cdiv;

inline int elementwise_grid(long long total) {
  const long long g = (total + THREADS - 1) / THREADS;
  return (int)(g < 8 * 132 * 8 ? g : 8 * 132 * 8);
}

// Per-BN scratch: statistics partials (forward) or backward sums partials,
// and the folded rows.
struct BnScratch {
  float *pa, *pb, *rstd, *scale, *shift;
};

BnScratch bn_scratch(Arena& ar, int rows, int C) {
  const int parts = cdiv(rows, BM) > cdiv(rows, EW_ROWS) ? cdiv(rows, BM)
                                                         : cdiv(rows, EW_ROWS);
  BnScratch s;
  s.pa = ar.take((size_t)parts * C);
  s.pb = ar.take((size_t)parts * C);
  s.rstd = ar.take(C);
  s.scale = ar.take(C);
  s.shift = ar.take(C);
  return s;
}

// The moments and folded rows of one BN from the tile partials in s.pa /
// s.pb of a conv with `rows` rows and C channels.
cudaError_t finalize(const BnScratch& s, int rows, int C, const float* gamma, const float* beta,
                     float eps, float* mean, float* var, cudaStream_t st) {
  bn_finalize_kernel<<<cdiv(C, 32), dim3(32, 32), 0, st>>>(
      s.pa, s.pb, cdiv(rows, BM), rows, C, gamma, beta, eps, mean, var, s.rstd, s.scale, s.shift);
  return cudaGetLastError();
}

cudaError_t fold_saved(const BnScratch& s, const float* mean, const float* var,
               const float* gamma, const float* beta, float eps, int C,
               cudaStream_t st) {
  bn_fold_kernel<<<cdiv(C, 128), 128, 0, st>>>(mean, var, gamma, beta, eps, C,
                                               s.rstd, s.scale, s.shift);
  return cudaGetLastError();
}

// Backward sums of one BN: dp (into dp_out unless null) and the two
// per-channel sums into sum_dp / sum_dpyh.
template <typename GT>
cudaError_t bwd_sums(const GT* g, const float* mask, const float* y,
             const float* mean, const BnScratch& s, const float* gamma,
             const float* beta, float* dp_out, float* sum_dp, float* sum_dpyh,
             int rows, int C, cudaStream_t st) {
  const int blocks = cdiv(rows, EW_ROWS);
  bn_bwd_sums_kernel<GT><<<dim3(blocks, cdiv(C, 32)), dim3(32, 8), 0, st>>>(
      g, mask, y, mean, s.rstd, gamma, beta, dp_out, s.pa, s.pb, rows, C);
  CHECK(cudaGetLastError());
  sum_partials_kernel<<<cdiv(C, 32), dim3(32, 32), 0, st>>>(
      s.pa, s.pb, blocks, C, sum_dp, sum_dpyh);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t bwd_apply(const float* dp, const float* y, const float* mean,
              const BnScratch& s, const float* gamma, const float* sum_dp,
              const float* sum_dpyh, OutT* dy, long long rows, int C,
              cudaStream_t st) {
  const long long total = rows * C;
  bn_bwd_apply_kernel<OutT><<<elementwise_grid(total), THREADS, 0, st>>>(
      dp, y, mean, s.rstd, gamma, sum_dp, sum_dpyh, (float)rows, dy, total, C);
  return cudaGetLastError();
}

// a = rnd(relu(y * scale + shift)) of one BN, in the compute dtype.
template <typename T>
cudaError_t activate(const float* y, const BnScratch& s, T* a, long long rows, int C,
                     cudaStream_t st) {
  const long long total = rows * C;
  bn_act_kernel<T><<<elementwise_grid(cdiv(total, 4)), THREADS, 0, st>>>(y, s.scale, s.shift, a,
                                                                         total, C);
  return cudaGetLastError();
}

inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// A buffer of count elements of T out of the arena.
template <typename T>
T* take_as(Arena& ar, size_t count) {
  return reinterpret_cast<T*>(ar.take((count * sizeof(T) + sizeof(float) - 1) / sizeof(float)));
}

// Where a tensor in the compute dtype that one elementwise pass forms from
// an fp32 one (a cotangent, an activated conv operand) goes: over its fp32
// source `alias` under fp32 compute (in place), in a buffer of its own
// under bf16 compute.
template <typename T>
T* compute_copy(Arena& ar, float* alias, size_t count) {
  if constexpr (std::is_same<T, float>::value)
    return alias;
  else
    return take_as<T>(ar, count);
}

// The weight gradient on the pipelined core: partials per row split, then
// the fixed-order fp64 combine, rounded once to T.
template <typename T>
cudaError_t wgrad_sm90(const sm90::ConvPlan& p, const T* src, const T* dy, float* part, T* dw,
                       cudaStream_t st) {
  CHECK(sm90::conv_wgrad(p, src, dy, part, st));
  const long long count = (long long)p.cls[0].ntaps * p.cs * p.cout;
  split_reduce_kernel<T><<<elementwise_grid(count), THREADS, 0, st>>>(
      part, sm90::wgrad_splits<T>(p), count, dw);
  return cudaGetLastError();
}

// The BN backward of a residual block's last BN (pre-BN y, saved mean m,
// folded rows s, gamma g) and, when ys is set, of its shortcut BN (ys, ms,
// ss, gs), in two passes: bot_dz_sums_kernel writes dz and the partials,
// whose fixed-order fp64 combine gives db / dg (and dgs; the shortcut's
// dbs is db), then bot_dz_apply_kernel writes dy (and dys) in the compute
// dtype. Without ys the shortcut is x. Four channels a thread where C %
// 4 == 0, else one. tmp: C floats of scratch.
template <typename T>
cudaError_t residual_bn_bwd(const float* y, const float* m, const BnScratch& s, const float* g,
                            float* db, float* dg, T* dy, const float* ys, const float* ms,
                            const BnScratch& ss, const float* gs, float* dbs, float* dgs, T* dys,
                            const T* x, const T* gout, T* dz, float* tmp, int rows, int C,
                            cudaStream_t st) {
  const bool proj = ys != nullptr;
  const int blocks = cdiv(rows, EW_ROWS);
  const long long total = (long long)rows * C;
  auto passes = [&](auto width) -> cudaError_t {
    constexpr int W = decltype(width)::value;
    bot_dz_sums_kernel<T, W><<<dim3(blocks, cdiv(C, 32 * W)), dim3(32, 8), 0, st>>>(
        y, s.scale, s.shift, m, s.rstd, ys, proj ? ss.scale : kNone, proj ? ss.shift : kNone, ms,
        proj ? ss.rstd : kNone, proj ? nullptr : x, gout, dz, s.pa, s.pb, ss.pa, rows, C);
    CHECK(cudaGetLastError());
    sum_partials_kernel<<<cdiv(C, 32), dim3(32, 32), 0, st>>>(s.pa, s.pb, blocks, C, db, dg);
    CHECK(cudaGetLastError());
    if (proj) {
      sum_partials_kernel<<<cdiv(C, 32), dim3(32, 32), 0, st>>>(ss.pa, ss.pa, blocks, C, tmp, dgs);
      CHECK(cudaGetLastError());
      CHECK(cudaMemcpyAsync(dbs, db, sizeof(float) * C, cudaMemcpyDeviceToDevice, st));
    }
    bot_dz_apply_kernel<T, W><<<elementwise_grid(cdiv(total, W)), THREADS, 0, st>>>(
        dz, y, m, s.rstd, g, db, dg, ys, ms, proj ? ss.rstd : kNone, gs, dgs, (float)rows, dy, dys,
        total, C);
    return cudaGetLastError();
  };
  if (C % 4 == 0) return passes(std::integral_constant<int, 4>());
  return passes(std::integral_constant<int, 1>());
}

// The core's statistics epilogue: y (fp32) with its tile statistics in the
// BN's partials.
template <typename T>
sm90::Epilogue<T, float, float> with_stats(float* y, const BnScratch& bn) {
  return sm90::Epilogue<T, float, float>{y, nullptr, nullptr, kNone, kNone, bn.pa, bn.pb};
}

// A residual block's last pass, bot_out_kernel: y (pre-BN, fp32) through
// its folded BN s, plus the shortcut (ys through ss for the projection,
// else x), ReLU, into out in the compute dtype. Four elements a thread
// where C % 4 == 0, else one.
template <typename T>
cudaError_t residual_out(const float* y, const BnScratch& s, const float* ys,
                         const BnScratch& ss, const T* x, T* out, int rows, int C,
                         cudaStream_t st) {
  const bool proj = ys != nullptr;
  const long long total = (long long)rows * C;
  auto pass = [&](auto width) -> cudaError_t {
    constexpr int W = decltype(width)::value;
    bot_out_kernel<T, W><<<elementwise_grid(total / W), THREADS, 0, st>>>(
        y, s.scale, s.shift, ys, proj ? ss.scale : kNone, proj ? ss.shift : kNone,
        proj ? nullptr : x, out, total, C);
    return cudaGetLastError();
  };
  if (C % 4 == 0) return pass(std::integral_constant<int, 4>());
  return pass(std::integral_constant<int, 1>());
}

// ---------------------------------------------------------------------------
// The stem: conv3x3/s1 + train-mode BN + ReLU, forward and backward, each as
// two passes over the batch that recompute the conv (stem_fwd_impl,
// stem_bwd_impl).
// ---------------------------------------------------------------------------
//
// Replaces _stem_fwd_kernel :401 and _stem_bwd_kernel :443 of
// pallas_conv.py and keeps their schedule: two phases over the batch, the
// conv recomputed in each, y never in memory.
//   forward  pass 1 (FWD_STATS): y of each 128-row tile, its mean and
//              centred sum of squares per channel (bn_finalize_kernel's
//              partials); bn_finalize_kernel: the moments in fp64, then
//              scale and shift;
//            pass 2 (FWD_OUT): the same y, out = rnd(relu(fmaf(y, scale,
//              shift))) (bn_apply_kernel's fmaf before it) in the compute
//              dtype.
//   backward bn_fold_kernel: rstd from the saved moments;
//            pass 1 (BWD_SUMS): y, yh = (y - mean) rstd, dp = gout where
//              yh gamma + beta > 0; per-CTA partials of sum dp and sum dp
//              yh, combined in fp64 by sum_partials_kernel into dbeta and
//              dgamma;
//            pass 2 (BWD_DW): y and dp again, dy = rstd gamma (dp - dbeta /
//              n - yh dgamma / n) rounded to the compute dtype (where the
//              Pallas _dw_accumulate casts it), dk += im2col(x)^T dy over
//              the CTA's tiles: one [K, cout] partial a CTA, combined in
//              fp64 by split_reduce_kernel and rounded once. With dx wanted
//              pass 2 also writes dy, and the core's transposed 3x3
//              (transposed3_plan, s = 1) takes dx from it.
// The BN backward is not folded into one pass (sum x dp - (sum dp / n) sum
// x - ...): that would skip the rounding of dy before the weight product.
//
// What bounds it: bytes. At the recipe ([512, 32, 32, 3] -> 64) a conv is
// 2 * 524288 * 27 * 64 = 1.81 GFLOP, 27 us at the fp32 FMA peak, while the
// fp32 y is 134 MB, whose write and read back cost 80 us of HBM: so the
// passes recompute y, where the blocks, whose convs are 60-80 GFLOP,
// stage theirs. The forward's floor is out written once (x is 6 MB); the
// backward reads gout once a pass, so its floor is about twice the
// one-read bound, ~80 us fp32 and ~40 us bf16.
//
// Design. 256 threads a CTA, a tile of 128 rows (the statistics tile) x 64
// channels (blockIdx.y picks the 64-channel block; the edge is masked). K =
// 9 cin is packed (kh, kw, ci), the order of the HWIO weight rows, and
// walked in 32-deep chunks that may straddle taps (one chunk at the recipe,
// 27 zero-padded to 32, whose weights then stay in shared memory for the
// CTA's whole walk). Two threads gather a tile row's im2col values straight
// from x into registers, sixteen each, a tile ahead of the one that
// computes (with one K chunk): in the flattened x each sits at a fixed
// offset from the row's pixel, masked by the taps inside the image, so a
// tile's rows need not align with image rows, and L1/L2 serve the overlap
// of neighbouring rows (x is 6 MB at the recipe). y is formed in registers:
// fp32 FMA on 8 x 4 micro-tiles (no TF32; 8 x 8 would need 128-thread CTAs
// for a 64-channel tile), bf16 mma.sync m16n8k16 with fp32 accumulators (two
// k-steps at the recipe, too few for a wgmma pipeline to pay). The same
// function forms y in every pass, in one K order, so each pass's y is
// bitwise the others'. The epilogues work on y where the product leaves
// it, in registers, and the channel sums go through a small shared scratch
// in a fixed order of the threads. The big tensors move 16 bytes a thread
// along rows (one element at a time where cout is no multiple of the
// 16-byte width): the backward's gout tile comes in by cp.async while y
// forms, and each thread overwrites its own cells of it with dy, which the
// weight gradient then reads; the fp32 out leaves from the registers (four
// channels of a row a thread), the bf16 out (whose fragments hold channel
// pairs) through the same tile. The weight gradient: fp32 FMA on 4 x 8
// micro-tiles over a quarter of the tile's rows each (the quarters combined
// once, after the walk), bf16 mma.sync with both operands through
// ldmatrix.trans. CTAs persist: as many as stay resident (the occupancy is
// asked once), each walking tiles blockIdx.x, + gridDim.x, ...; every
// partial is summed in a fixed order and there are no atomics, so each
// output is bitwise repeatable.
namespace stem {

constexpr int BN = 64;        // output channels of a CTA
constexpr int KC = 32;        // K chunk
constexpr int AUX_ROWS = 6;   // per-channel rows a pass reads

enum Mode { FWD_STATS, FWD_OUT, BWD_SUMS, BWD_DW };

struct Params {
  int n, h, w, cin, cout;
  int rows, tiles, K, nk;  // n h w; cdiv(rows, BM); 9 cin; cdiv(K, KC)
};

// What a pass reads and writes; null where the pass has no use for it.
template <typename T>
struct IO {
  const T* x;                  // [n, h, w, cin]
  const T* k;                  // HWIO [3, 3, cin, cout], i.e. [K, cout]
  const T* gout;               // backward: [n, h, w, cout]
  const float* row[AUX_ROWS];  // FWD_OUT: scale, shift; BWD_*: mean, rstd,
                               // gamma, beta, sum dp, sum dp yh
  T* out;                      // FWD_OUT: out; BWD_DW: dy (for dx; may be null)
  float* pa;                   // FWD_STATS: tile means [tiles, cout]; BWD_SUMS:
  float* pb;                   // sum dp / sum dp yh [ctas, cout]; BWD_DW: pa is
                               // dk [ctas, K, cout]
};

// A CTA's shared memory (byte offsets): the im2col chunk As [BM][ALD]
// (row-major, K along), the weight chunk Bs (fp32 [KC][BN], bf16 [BN][ALD]:
// the mma's column-major B), the tile Ts [BM][TLD] of the compute dtype
// (the backward's gout, overwritten by dy; the bf16 forward's out; after
// the fp32 walk the dk quarters), the channel sums' scratch [32][BN] fp32,
// then the per-channel rows [AUX_ROWS][BN] and the tile means [BN]. The
// pitches keep the fragment accesses and ldmatrix rows on distinct banks.
template <typename T>
struct Smem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int ALD = F32 ? KC + 4 : KC + 8;  // As row pitch (elements)
  static constexpr int TLD = F32 ? BN + 4 : BN + 8;  // Ts row pitch (elements)
  static constexpr int A = 0;
  static constexpr int B = A + BM * ALD * (int)sizeof(T);
  static constexpr int TL = B + (F32 ? KC * BN : BN * ALD) * (int)sizeof(T);
  static constexpr int RED = TL + BM * TLD * (int)sizeof(T);
  static constexpr int AUX = RED + 32 * BN * 4;
  static constexpr int BYTES = AUX + (AUX_ROWS + 1) * BN * 4;
};

// Two floats rounded to bf16 in one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b over one 16 x 8 x 16 tile: bf16 operands, fp32 accumulators.
// Fragments (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4): a holds
// A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b holds
// B[2t..2t+1][g], B[2t+8..2t+9][g]; d holds D[g][2t..2t+1], D[g+8][2t..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 i .. 8 i
// + 7 give the addresses of matrix i's eight 16-byte rows, and register i
// of lane l holds elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of
// matrix i as stored.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

// A thread's share of chunk kc of tile m0's im2col rows, loaded into
// registers (so the next tile's loads fly while this one computes): row r
// = tid / 2, columns c0 .. c0 + 15 (c0 = 16 (tid % 2)). Column kk holds x
// at K index k = kc KC + kk, i.e. at tap k / cin = 3 kh + kw and channel k
// % cin (the HWIO weight row k), pixel (i + kh - 1, j + kw - 1) of the
// row's pixel (b, i, j); zero outside the image, past K and past the rows.
// In the flattened [n h w, cin] x that element sits at a fixed offset from
// the row's pixel, ((kh - 1) w + kw - 1) cin + ci, which grows by one
// along k but at a new kh; the taps inside the image are a 9-bit mask of
// the row.
template <typename T>
__device__ __forceinline__ void gather_load(T (&v)[16], const T* __restrict__ x, const Params& p,
                                            int m0, int kc) {
  const int m = m0 + (threadIdx.x >> 1);
  unsigned taps = 0;  // bit 3 kh + kw: tap (kh, kw) inside the image
  if (m < p.rows) {
    const int q = m / p.w, j = m - q * p.w, i = q - (q / p.h) * p.h;
    const unsigned cols = (j > 0 ? 1u : 0u) | 2u | (j < p.w - 1 ? 4u : 0u);
    taps = (i > 0 ? cols : 0u) | (cols << 3) | (i < p.h - 1 ? cols << 6 : 0u);
  }
  const int k = kc * KC + (threadIdx.x & 1) * 16;
  int t = k / p.cin;
  int ci = k - t * p.cin, kw = t - 3 * (t / 3);
  int off = ((t / 3 - 1) * p.w + kw - 1) * p.cin + ci;
  const T* row = x + (long long)m * p.cin;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    v[e] = t < 9 && ((taps >> t) & 1u) ? row[off] : from_f<T>(0.f);
    ++off;
    if (++ci == p.cin) {
      ci = 0;
      ++t;
      if (++kw == 3) {
        kw = 0;
        off += (p.w - 3) * p.cin;
      }
    }
  }
}

// The loaded share into As (16-byte stores).
__device__ __forceinline__ void gather_store(float* As, const float (&v)[16]) {
  float* d = As + (threadIdx.x >> 1) * Smem<float>::ALD + (threadIdx.x & 1) * 16;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    sm90::store4(d + 4 * q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
}
__device__ __forceinline__ void gather_store(bf16* As, const bf16 (&v)[16]) {
  uint4* d = reinterpret_cast<uint4*>(As + (threadIdx.x >> 1) * Smem<bf16>::ALD +
                                      (threadIdx.x & 1) * 16);
  uint32_t w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    w[q] = (uint32_t)__bfloat16_as_ushort(v[2 * q]) |
           ((uint32_t)__bfloat16_as_ushort(v[2 * q + 1]) << 16);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Chunk kc of the weights' channels n0 .. n0 + BN - 1 into Bs; zero past K
// and past cout. Eight consecutive channels a thread.
template <typename T>
__device__ __forceinline__ void load_b(T* Bs, const T* __restrict__ wt, const Params& p, int n0,
                                       int kc) {
  const int kk = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 8, k = kc * KC + kk;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = n0 + c0 + e;
    const T v = k < p.K && c < p.cout ? wt[(long long)k * p.cout + c] : from_f<T>(0.f);
    if constexpr (Smem<T>::F32)
      Bs[kk * BN + c0 + e] = v;
    else
      Bs[(c0 + e) * Smem<T>::ALD + kk] = v;
  }
}

// The depth of chunk kc that y multiplies: its K, rounded up to the FMA
// loop's 4 (fp32) or the mma's 16 (bf16); As and Bs are zero past K.
template <typename T>
__device__ __forceinline__ int chunk_depth(const Params& p, int kc) {
  const int k = p.K - kc * KC < KC ? p.K - kc * KC : KC;
  return Smem<T>::F32 ? (k + 3) & ~3 : (k + 15) & ~15;
}

// y += the chunk's product, fp32 FMA: thread (tx, ty) = (tid % 16, tid /
// 16) owns rows ty + 16 i (i < 8) and channels 4 tx .. 4 tx + 3, acc[4 i +
// j]; A read four K at a time along its rows (a warp reads two rows).
__device__ __forceinline__ void y_chunk(const float* As, const float* Bs, int kn,
                                        float (&acc)[32]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int kk = 0; kk < kn; kk += 4) {
    float4 b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = *reinterpret_cast<const float4*>(Bs + (kk + u) * BN + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * Smem<float>::ALD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float av = sm90::comp(a, u);
        acc[4 * i + 0] = fmaf(av, b[u].x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(av, b[u].y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(av, b[u].z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(av, b[u].w, acc[4 * i + 3]);
      }
    }
  }
}

// The same on the tensor cores: warp w multiplies rows 32 (w % 4) .. + 31
// and channels 32 (w / 4) .. + 31 as 2 x 4 mma tiles, acc[16 i + 4 j + e]
// the fragment of tile (i, j).
__device__ __forceinline__ void y_chunk(const bf16* As, const bf16* Bs, int kn,
                                        float (&acc)[32]) {
  constexpr int LD = Smem<bf16>::ALD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  for (int kk = 0; kk < kn; kk += 16) {
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16* a = As + (wm + 16 * i + gq) * LD + kk + 2 * tq;
      af[i][0] = ld32(a);
      af[i][1] = ld32(a + 8 * LD);
      af[i][2] = ld32(a + 8);
      af[i][3] = ld32(a + 8 * LD + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* b = Bs + (wn + 8 * j + gq) * LD + kk + 2 * tq;
      bfr[j][0] = ld32(b);
      bfr[j][1] = ld32(b + 8);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 16 * i + 4 * j), af[i], bfr[j][0],
                 bfr[j][1]);
  }
}

// The y tile as a thread holds it after y_chunk: NR rows of NG groups of GW
// consecutive channels, acc[idx(ri, g, e)] at tile row row(ri), channel
// col(g) + e. fp32: rows ty + 16 i, channels 4 tx .. 4 tx + 3. bf16: the
// mma fragments, rows 32 (w % 4) + 16 i + g (+ 8), channels 32 (w / 4) + 8
// j + 2 t (+ 1). slot() numbers the SLOTS threads that hold each channel,
// the order in which their partials are summed.
template <typename T>
struct Frag;
template <>
struct Frag<float> {
  static constexpr int NR = 8, NG = 1, GW = 4, SLOTS = 16;
  __device__ static int row(int ri) { return (threadIdx.x >> 4) + 16 * ri; }
  __device__ static int col(int) { return 4 * (threadIdx.x & 15); }
  __device__ static int idx(int ri, int, int e) { return 4 * ri + e; }
  __device__ static int slot() { return threadIdx.x >> 4; }
};
template <>
struct Frag<bf16> {
  static constexpr int NR = 4, NG = 4, GW = 2, SLOTS = 32;
  __device__ static int row(int ri) {
    return ((threadIdx.x >> 5) & 3) * 32 + 16 * (ri >> 1) + ((threadIdx.x & 31) >> 2) + 8 * (ri & 1);
  }
  __device__ static int col(int g) { return (threadIdx.x >> 7) * 32 + 8 * g + 2 * (threadIdx.x & 3); }
  __device__ static int idx(int ri, int g, int e) { return 16 * (ri >> 1) + 4 * g + 2 * (ri & 1) + e; }
  __device__ static int slot() { return ((threadIdx.x >> 5) & 3) * 8 + ((threadIdx.x & 31) >> 2); }
};

// fp32 out: four consecutive channels of a row, one 16-byte store where
// vec, else the first n one at a time.
__device__ __forceinline__ void store_gw(float* p, bool vec, int n, const float (&v)[4]) {
  if (vec) {
    sm90::store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = v[e];
  }
}

// The big tensors' tiles (gout in; the bf16 out, and dy for dx, out) go
// through Ts, so that global memory sees 16-byte accesses along rows (not
// bf16 fragments' channel pairs) and gout lands while y forms. Rows m0 ..
// m0 + BM - 1, channels n0 .. n0 + BN - 1 of a [rows, cout] tensor to or
// from Ts, sixteen bytes a thread: by cp.async (in; zero-filled past the
// rows and channels, committed as one group) or stores (out) where cout is
// a multiple of the 16-byte width, else one element at a time.
template <typename T>
__device__ __forceinline__ void tile_in(T* Ts, const T* __restrict__ g, const Params& p, int m0,
                                        int n0) {
  constexpr int V = 16 / (int)sizeof(T), GPR = BN / V;
  const bool vec = p.cout % V == 0;
  for (int i = threadIdx.x; i < BM * GPR; i += THREADS) {
    const int r = i / GPR, c = (i % GPR) * V, m = m0 + r, cg = n0 + c;
    T* d = Ts + r * Smem<T>::TLD + c;
    const T* src = g + (long long)m * p.cout + cg;
    if (vec) {
      const bool ok = m < p.rows && cg < p.cout;
      sm90::cp_async16(d, ok ? src : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = m < p.rows && cg + e < p.cout ? src[e] : from_f<T>(0.f);
    }
  }
  sm90::cp_async_commit();
}
template <typename T>
__device__ __forceinline__ void tile_out(const T* Ts, T* g, const Params& p, int m0, int nrows,
                                         int n0) {
  constexpr int V = 16 / (int)sizeof(T), GPR = BN / V;
  const bool vec = p.cout % V == 0;
  for (int i = threadIdx.x; i < BM * GPR; i += THREADS) {
    const int r = i / GPR, c = (i % GPR) * V, cg = n0 + c;
    if (r >= nrows || cg >= p.cout) continue;
    const T* src = Ts + r * Smem<T>::TLD + c;
    T* d = g + (long long)(m0 + r) * p.cout + cg;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (cg + e < p.cout) d[e] = src[e];
    }
  }
}

// GW channels of one row of Ts to or from floats (a thread's own cells).
__device__ __forceinline__ void get_gw(const float* Ts, int r, int c, float (&v)[4]) {
  const float4 q = sm90::load4(Ts + r * Smem<float>::TLD + c);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void get_gw(const bf16* Ts, int r, int c, float (&v)[2]) {
  const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(Ts + r * Smem<bf16>::TLD + c);
  v[0] = __low2float(q);
  v[1] = __high2float(q);
}
__device__ __forceinline__ void put_gw(float* Ts, int r, int c, const float (&v)[4]) {
  sm90::store4(Ts + r * Smem<float>::TLD + c, make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void put_gw(bf16* Ts, int r, int c, const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(Ts + r * Smem<bf16>::TLD + c) = pack_bf16(v[0], v[1]);
}

// Per channel of the tile, the sum of the threads' partials v[g GW + e]
// (channel col(g) + e) in slot order, through red [SLOTS][BN]: thread c <
// BN gets channel c's. Syncs once; the caller syncs before red is written
// again.
template <typename T>
__device__ __forceinline__ float column_sum(float* red, const float (&v)[Frag<T>::NG * Frag<T>::GW]) {
  using F = Frag<T>;
#pragma unroll
  for (int g = 0; g < F::NG; ++g)
#pragma unroll
    for (int e = 0; e < F::GW; ++e) red[F::slot() * BN + F::col(g) + e] = v[g * F::GW + e];
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < BN)
    for (int q = 0; q < F::SLOTS; ++q) s += red[q * BN + threadIdx.x];
  return s;
}

// dk += the chunk in As (transposed) times the dy tile, fp32 FMA: thread
// (cq, kq, rq) = (tid % 8, tid / 8 % 8, tid / 64) owns chunk rows 4 kq ..
// 4 kq + 3 and channels 4 cq .. + 3 and 32 + 4 cq .. + 3, dk[8 i + j], over
// the tile's rows 32 rq .. 32 rq + 31.
__device__ __forceinline__ void dk_tile(const float* As, const float* Dy, float (&dk)[32]) {
  const int cq = threadIdx.x & 7, kq = (threadIdx.x >> 3) & 7, rq = threadIdx.x >> 6;
#pragma unroll 4
  for (int rr = 0; rr < 32; ++rr) {
    const int r = 32 * rq + rr;
    const float4 a = *reinterpret_cast<const float4*>(As + r * Smem<float>::ALD + 4 * kq);
    const float4 d0 = *reinterpret_cast<const float4*>(Dy + r * Smem<float>::TLD + 4 * cq);
    const float4 d1 = *reinterpret_cast<const float4*>(Dy + r * Smem<float>::TLD + 32 + 4 * cq);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dk[8 * i + j] = fmaf(av[i], dv[j], dk[8 * i + j]);
  }
}

// The same on the tensor cores: warp w takes chunk rows 16 (w % 2) .. + 15
// and channels 16 (w / 2) .. + 15 (two n8 tiles, dk[4 jn + e]), the tile's
// 128 rows as the mma's K in eight 16-row steps; A = As^T and B = the dy tile
// through ldmatrix.trans.
__device__ __forceinline__ void dk_tile(const bf16* As, const bf16* Dy, float (&dk)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 16, c0 = (warp >> 1) * 16, i = lane >> 3, j = lane & 7;
#pragma unroll 2
  for (int r0 = 0; r0 < BM; r0 += 16) {
    uint32_t a[4], b[4];
    ldsm_x4_trans(a, As + (r0 + j + 8 * (i >> 1)) * Smem<bf16>::ALD + m0 + 8 * (i & 1));
    ldsm_x4_trans(b, Dy + (r0 + j + 8 * (i & 1)) * Smem<bf16>::TLD + c0 + 8 * (i >> 1));
    mma_bf16(*reinterpret_cast<float(*)[4]>(dk), a, b[0], b[1]);
    mma_bf16(*reinterpret_cast<float(*)[4]>(dk + 4), a, b[2], b[3]);
  }
}

// Two CTAs an SM under fp32 (the weight gradient's 32 partials beside y's
// 32 accumulators need up to 128 registers), three under bf16 (80-odd
// registers; the third CTA hides more of each tile's latency).
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, Smem<T>::F32 ? 2 : 3)
    stem_kernel(const IO<T> io, const Params p) {
  using S = Smem<T>;
  using F = Frag<T>;
  constexpr int NC = F::NG * F::GW;  // channels a thread holds
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem + S::A);
  T* Bs = reinterpret_cast<T*>(smem + S::B);
  T* Ts = reinterpret_cast<T*>(smem + S::TL);
  float* red = reinterpret_cast<float*>(smem + S::RED);
  float* aux = reinterpret_cast<float*>(smem + S::AUX);    // [AUX_ROWS][BN], then tmean
  float* tmean = aux + AUX_ROWS * BN;
  const int tid = threadIdx.x, n0 = blockIdx.y * BN, kz = blockIdx.z;
  const float count = (float)p.rows;
#pragma unroll
  for (int j = 0; j < AUX_ROWS; ++j)
    if (tid < BN) aux[j * BN + tid] = io.row[j] && n0 + tid < p.cout ? io.row[j][n0 + tid] : 0.f;
  // one K chunk (the recipe's): its weights stay for the whole walk, and
  // each tile's im2col loads are issued a tile ahead
  const bool ahead = p.nk == 1;
  T pre[16];
  if (ahead) {
    load_b(Bs, io.k, p, n0, 0);
    if (blockIdx.x < p.tiles) gather_load(pre, io.x, p, blockIdx.x * BM, 0);
  }
  float dk[32], sa[NC], sb[NC];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) sa[i] = sb[i] = 0.f;

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = t * BM, nrows = p.rows - m0 < BM ? p.rows - m0 : BM;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < p.nk; ++kc) {
      __syncthreads();  // the last tile's (chunk's) readers are done
      if constexpr (MODE >= BWD_SUMS)
        if (kc == 0) tile_in(Ts, io.gout, p, m0, n0);  // lands while y forms
      if (!ahead) {
        gather_load(pre, io.x, p, m0, kc);
        load_b(Bs, io.k, p, n0, kc);
      }
      gather_store(As, pre);
      __syncthreads();
      if (ahead && t + (int)gridDim.x < p.tiles)
        gather_load(pre, io.x, p, m0 + (int)gridDim.x * BM, 0);
      y_chunk(As, Bs, chunk_depth<T>(p, kc), acc);
    }

    // the epilogues work on y in the registers (F's layout)
    if constexpr (MODE >= BWD_SUMS) {
      sm90::cp_async_wait<0>();
      __syncthreads();  // the gout tile
    }
    if constexpr (MODE == FWD_STATS) {
      // the tile's mean per channel, then the sum of squares about it: each
      // thread over its rows, then the slots in order
      float v[NC];
#pragma unroll
      for (int g = 0; g < F::NG; ++g)
#pragma unroll
        for (int e = 0; e < F::GW; ++e) {
          float s = 0.f;
#pragma unroll
          for (int ri = 0; ri < F::NR; ++ri)
            if (F::row(ri) < nrows) s += acc[F::idx(ri, g, e)];
          v[g * F::GW + e] = s;
        }
      const float sum = column_sum<T>(red, v);
      if (tid < BN) tmean[tid] = sum / (float)nrows;
      __syncthreads();
#pragma unroll
      for (int g = 0; g < F::NG; ++g)
#pragma unroll
        for (int e = 0; e < F::GW; ++e) {
          const float mu = tmean[F::col(g) + e];
          float s = 0.f;
#pragma unroll
          for (int ri = 0; ri < F::NR; ++ri)
            if (F::row(ri) < nrows) {
              const float d = acc[F::idx(ri, g, e)] - mu;
              s = fmaf(d, d, s);
            }
          v[g * F::GW + e] = s;
        }
      const float m2 = column_sum<T>(red, v);
      if (tid < BN && n0 + tid < p.cout) {
        const long long o = (long long)t * p.cout + n0 + tid;
        io.pa[o] = tmean[tid];
        io.pb[o] = m2;
      }
    } else {
#pragma unroll
      for (int g = 0; g < F::NG; ++g) {
        const int c = F::col(g);
        const int nval = p.cout - n0 - c < 0 ? 0 : (p.cout - n0 - c < F::GW ? p.cout - n0 - c : F::GW);
        const bool vec = p.cout % F::GW == 0 && nval == F::GW;
#pragma unroll
        for (int ri = 0; ri < F::NR; ++ri) {
          const int r = F::row(ri);
          const long long o = (long long)(m0 + r) * p.cout + n0 + c;
          float v[F::GW];
          if constexpr (MODE == FWD_OUT) {
            if (r < nrows && nval > 0) {
#pragma unroll
              for (int e = 0; e < F::GW; ++e)
                v[e] = fmaxf(fmaf(acc[F::idx(ri, g, e)], aux[c + e], aux[BN + c + e]), 0.f);
              if constexpr (S::F32)
                store_gw(io.out + o, vec, nval, v);
              else
                put_gw(Ts, r, c, v);
            }
          } else {
            // BWD_SUMS: dp and its sums; BWD_DW: dy into the dy tile (zero
            // past the rows) and into io.out for dx
            float go[F::GW];
            get_gw(Ts, r, c, go);
#pragma unroll
            for (int e = 0; e < F::GW; ++e) {
              const float mu = aux[c + e], rs = aux[BN + c + e];
              const float ga = aux[2 * BN + c + e], be = aux[3 * BN + c + e];
              const float yh = (acc[F::idx(ri, g, e)] - mu) * rs;
              const float dp = fmaf(yh, ga, be) > 0.f ? go[e] : 0.f;
              if constexpr (MODE == BWD_SUMS) {
                sa[g * F::GW + e] += dp;
                sb[g * F::GW + e] = fmaf(dp, yh, sb[g * F::GW + e]);
              } else {
                const float db = aux[4 * BN + c + e], dg = aux[5 * BN + c + e];
                v[e] = r < nrows ? rs * ga * (dp - db / count - yh * dg / count) : 0.f;
              }
            }
            if constexpr (MODE == BWD_DW) put_gw(Ts, r, c, v);  // over gout: own cells
          }
        }
      }
      if constexpr (MODE == FWD_OUT && !S::F32) {
        __syncthreads();  // the out tile
        tile_out(Ts, io.out, p, m0, nrows, n0);
      }
      if constexpr (MODE == BWD_DW) {
        if (!ahead) {  // As holds the last chunk of y; dk wants chunk kz
          __syncthreads();
          gather_load(pre, io.x, p, m0, kz);
          gather_store(As, pre);
        }
        __syncthreads();
        if (io.out && kz == 0) tile_out(Ts, io.out, p, m0, nrows, n0);
        dk_tile(As, Ts, dk);
      }
    }
  }

  // after the walk: this CTA's partials, combined in a fixed order
  if constexpr (MODE == BWD_SUMS) {
    __syncthreads();
    const float a = column_sum<T>(red, sa);
    __syncthreads();
    const float b = column_sum<T>(red, sb);
    if (tid < BN && n0 + tid < p.cout) {
      io.pa[(long long)blockIdx.x * p.cout + n0 + tid] = a;
      io.pb[(long long)blockIdx.x * p.cout + n0 + tid] = b;
    }
  } else if constexpr (MODE == BWD_DW) {
    float* part = io.pa + (long long)blockIdx.x * p.K * p.cout;
    if constexpr (S::F32) {
      // the four row quarters through shared memory, summed in order
      __syncthreads();
      float* red4 = reinterpret_cast<float*>(Ts);  // [4][KC][BN]
      const int cq = tid & 7, kq = (tid >> 3) & 7, rq = tid >> 6;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red4[(rq * KC + 4 * kq + i) * BN + (j < 4 ? 4 * cq + j : 28 + 4 * cq + j)] = dk[8 * i + j];
      __syncthreads();
      for (int idx = tid; idx < KC * BN; idx += THREADS) {
        const int k = kz * KC + idx / BN, c = n0 + idx % BN;
        const float s = ((red4[idx] + red4[KC * BN + idx]) + red4[2 * KC * BN + idx]) +
                        red4[3 * KC * BN + idx];
        if (k < p.K && c < p.cout) part[(long long)k * p.cout + c] = s;
      }
    } else {
      const int lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kz * KC + (warp & 1) * 16 + gq + (e >= 2 ? 8 : 0);
          const int c = n0 + (warp >> 1) * 16 + 8 * jn + 2 * tq + (e & 1);
          if (k < p.K && c < p.cout) part[(long long)k * p.cout + c] = dk[4 * jn + e];
        }
    }
  }
}

Params params(int n, int h, int w, int cin, int cout) {
  Params p;
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.rows = n * h * w;
  p.tiles = cdiv(p.rows, BM);
  p.K = 9 * cin;
  p.nk = cdiv(p.K, KC);
  return p;
}

// A pass's grid: blockIdx.y the 64-channel block, blockIdx.z (BWD_DW) the K
// chunk of dk, blockIdx.x the CTAs that walk the tiles: as many as stay
// resident on the card beside the (y, z) blocks, at most one a tile. The
// same for every call on one card, so the partials' order is too. The
// residency (occupancy times SMs) is asked once per kernel.
template <typename T, int MODE>
cudaError_t grid(const Params& p, dim3* g) {
  static int resident = 0;
  if (resident == 0) {
    auto kernel = stem_kernel<T, MODE>;
    CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<T>::BYTES));
    int per_sm = 0, dev = 0, sms = 0;
    CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                        Smem<T>::BYTES));
    CHECK(cudaGetDevice(&dev));
    CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    resident = (per_sm > 1 ? per_sm : 1) * sms;
  }
  const int z = MODE == BWD_DW ? p.nk : 1, x = resident / (cdiv(p.cout, BN) * z);
  *g = dim3(x < 1 ? 1 : (x > p.tiles ? p.tiles : x), cdiv(p.cout, BN), z);
  return cudaSuccess;
}

template <typename T, int MODE>
cudaError_t pass(const IO<T>& io, const Params& p, dim3 g, cudaStream_t st) {
  return sm90::launch(stem_kernel<T, MODE>, g, Smem<T>::BYTES, st, io, p);
}

}  // namespace stem

}  // namespace

// ---------------------------------------------------------------------------
// Argument blocks (T: float or bf16, the compute dtype of x, the kernels,
// gout, out, dx and the weight gradients; every per-channel row is fp32)
// and the launch sequences, one template per entry point pair. Outside the
// anonymous namespace: the C entry points take these types, and would
// lose their external linkage with them.
// ---------------------------------------------------------------------------

// One argument block for both stem entry points; fields an entry point
// does not use are null. HWIO kernel k [3, 3, cin, cout]; kt is k with its
// channel axes swapped, [3, 3, cout, cin] (made by the caller).
template <typename T>
struct StemArgs {
  const T* x;          // [n, h, w, cin]
  const T* k;
  const T* kt;         // backward, when dx is wanted
  const float* gamma;  // [cout]
  const float* beta;
  const T* gout;       // backward: [n, h, w, cout]
  T* out;              // forward: [n, h, w, cout]
  float* mean;         // forward writes, backward reads: [cout]
  float* var;
  T* dx;               // backward outputs (dx may be null)
  T* dk;
  float* dgamma;
  float* dbeta;
  int n, h, w, cin, cout;
  float eps;
};

// Each entry point: with ws null, writes the workspace bytes it needs to
// *ws_bytes and launches nothing; otherwise launches its kernels on the
// caller's stream, does not synchronise, and returns the first
// cudaGetLastError() that is not cudaSuccess (0 when all launched).

template <typename T>
static int stem_fwd_impl(const StemArgs<T>* a, void* ws, size_t* ws_bytes, cudaStream_t st) {
  const stem::Params p = stem::params(a->n, a->h, a->w, a->cin, a->cout);
  Arena ar{static_cast<char*>(ws)};
  BnScratch s = bn_scratch(ar, p.rows, a->cout);  // pass 1's tile partials, the folded rows
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  dim3 g1, g2;
  CHECK((stem::grid<T, stem::FWD_STATS>(p, &g1)));
  CHECK((stem::grid<T, stem::FWD_OUT>(p, &g2)));
  stem::IO<T> io = {a->x, a->k};
  io.pa = s.pa;
  io.pb = s.pb;
  CHECK((stem::pass<T, stem::FWD_STATS>(io, p, g1, st)));
  CHECK(finalize(s, p.rows, a->cout, a->gamma, a->beta, a->eps, a->mean, a->var, st));
  io.row[0] = s.scale;
  io.row[1] = s.shift;
  io.out = a->out;
  return static_cast<int>(stem::pass<T, stem::FWD_OUT>(io, p, g2, st));
}

template <typename T>
static int stem_bwd_impl(const StemArgs<T>* a, void* ws, size_t* ws_bytes, cudaStream_t st) {
  const stem::Params p = stem::params(a->n, a->h, a->w, a->cin, a->cout);
  const int C = a->cout;
  dim3 g1, g2;
  CHECK((stem::grid<T, stem::BWD_SUMS>(p, &g1)));
  CHECK((stem::grid<T, stem::BWD_DW>(p, &g2)));
  Arena ar{static_cast<char*>(ws)};
  BnScratch s = bn_scratch(ar, p.rows, C);  // rstd and pass 1's CTA partials
  float* part = ar.take((size_t)g2.x * p.K * C);  // pass 2's dk partials
  // dy in the compute dtype, for dx alone
  T* dy = a->dx ? take_as<T>(ar, (size_t)p.rows * C) : nullptr;
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  CHECK(fold_saved(s, a->mean, a->var, a->gamma, a->beta, a->eps, C, st));
  stem::IO<T> io = {a->x, a->k, a->gout, {a->mean, s.rstd, a->gamma, a->beta}};
  io.pa = s.pa;
  io.pb = s.pb;
  CHECK((stem::pass<T, stem::BWD_SUMS>(io, p, g1, st)));
  sum_partials_kernel<<<cdiv(C, 32), dim3(32, 32), 0, st>>>(s.pa, s.pb, (int)g1.x, C, a->dbeta,
                                                           a->dgamma);
  CHECK(cudaGetLastError());
  io.row[4] = a->dbeta;
  io.row[5] = a->dgamma;
  io.out = dy;
  io.pa = part;
  io.pb = nullptr;
  CHECK((stem::pass<T, stem::BWD_DW>(io, p, g2, st)));
  const long long count = (long long)p.K * C;
  split_reduce_kernel<T><<<elementwise_grid(count), THREADS, 0, st>>>(part, (int)g2.x, count,
                                                                      a->dk);
  CHECK(cudaGetLastError());
  if (a->dx) {
    // dx = the transposed 3x3 of dy, [n, h, w, cout] with kt [3, 3, cout, cin]
    const sm90::ConvPlan d = sm90::transposed3_plan(a->n, a->h, a->w, C, a->h, a->w, a->cin, 1);
    CHECK(sm90::conv_gemm(d, dy, a->kt, sm90::Epilogue<T, T, T>{a->dx, nullptr, nullptr, kNone,
                                                                kNone}, st));
  }
  return 0;
}

// One argument block for both Bottleneck entry points. Kernels: k1
// [cin, P], k2 HWIO [3, 3, P, P], k3 [P, 4P], ks [cin, 4P] (projection
// only); the backward also takes k1t [P, cin], k2t [3, 3, P, P] (k2 with
// its channel axes swapped), k3t [4P, P], kst [4P, cin]. The moments are
// written by the forward and read by the backward. proj selects the
// 1x1/stride conv + BN shortcut; without it the shortcut is x itself
// (stride 1, cin == 4P).
template <typename T>
struct BotArgs {
  const T* x;  // [n, hi, wi, cin]
  const T* k1;
  const T* k2;
  const T* k3;
  const T* ks;
  const T* k1t;
  const T* k2t;
  const T* k3t;
  const T* kst;
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const float* g3;
  const float* b3;
  const float* gs;
  const float* bs;
  const T* gout;  // backward: [n, ho, wo, 4P]
  T* out;         // forward: [n, ho, wo, 4P]
  float* m1;
  float* v1;
  float* m2;
  float* v2;
  float* m3;
  float* v3;
  float* ms;
  float* vs;
  T* dx;
  T* dk1;
  T* dk2;
  T* dk3;
  T* dks;
  float* dg1;
  float* db1;
  float* dg2;
  float* db2;
  float* dg3;
  float* db3;
  float* dgs;
  float* dbs;
  int n, hi, wi, cin, planes, stride, proj;
  float eps;
};

// The Bottleneck's forward convolutions as plans of the pipelined core,
// which both entry points run them on, and its sizes.
struct BotGeoms {
  sm90::ConvPlan r1, r2, r3, rs;
  int rows1, rows2, P, C4;
};

template <typename T>
static BotGeoms bot_geoms(const BotArgs<T>* a) {
  BotGeoms b;
  const int s = a->stride, ho = a->hi / s, wo = a->wi / s;
  b.P = a->planes;
  b.C4 = 4 * a->planes;
  b.r1 = sm90::forward_plan(a->n, a->hi, a->wi, a->cin, 1, 1, b.P);
  b.r2 = sm90::forward_plan(a->n, a->hi, a->wi, b.P, 3, s, b.P);
  b.r3 = sm90::forward_plan(a->n, ho, wo, b.P, 1, 1, b.C4);
  b.rs = sm90::forward_plan(a->n, a->hi, a->wi, a->cin, 1, s, b.C4);
  b.rows1 = a->n * a->hi * a->wi;
  b.rows2 = a->n * ho * wo;
  return b;
}

template <typename T>
static int bottleneck_fwd_impl(const BotArgs<T>* a, void* ws, size_t* ws_bytes, cudaStream_t st) {
  const BotGeoms b = bot_geoms(a);
  const int P = b.P, C4 = b.C4;
  Arena ar{static_cast<char*>(ws)};
  // pre-BN y in fp32 and, for the next conv, a = rnd(relu(y * scale +
  // shift)) in the compute dtype (over y under fp32)
  float* y1 = ar.take((size_t)b.rows1 * P);
  T* a1 = compute_copy<T>(ar, y1, (size_t)b.rows1 * P);
  float* y2 = ar.take((size_t)b.rows2 * P);
  T* a2 = compute_copy<T>(ar, y2, (size_t)b.rows2 * P);
  float* ys = a->proj ? ar.take((size_t)b.rows2 * C4) : nullptr;
  BnScratch s1 = bn_scratch(ar, b.rows1, P);
  BnScratch s2 = bn_scratch(ar, b.rows2, P);
  BnScratch s3 = bn_scratch(ar, b.rows2, C4);
  BnScratch ss = bn_scratch(ar, b.rows2, C4);
  // y3 is staged in out and the last pass runs in place (fp32)
  float* y3 = staged(ar, a->out, (size_t)b.rows2 * C4);
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  CHECK(sm90::conv_gemm(b.r1, a->x, a->k1, with_stats<T>(y1, s1), st));
  CHECK(finalize(s1, b.rows1, P, a->g1, a->b1, a->eps, a->m1, a->v1, st));
  CHECK(activate(y1, s1, a1, b.rows1, P, st));
  CHECK(sm90::conv_gemm(b.r2, a1, a->k2, with_stats<T>(y2, s2), st));
  CHECK(finalize(s2, b.rows2, P, a->g2, a->b2, a->eps, a->m2, a->v2, st));
  CHECK(activate(y2, s2, a2, b.rows2, P, st));
  CHECK(sm90::conv_gemm(b.r3, a2, a->k3, with_stats<T>(y3, s3), st));
  CHECK(finalize(s3, b.rows2, C4, a->g3, a->b3, a->eps, a->m3, a->v3, st));
  if (a->proj) {
    CHECK(sm90::conv_gemm(b.rs, a->x, a->ks, with_stats<T>(ys, ss), st));
    CHECK(finalize(ss, b.rows2, C4, a->gs, a->bs, a->eps, a->ms, a->vs, st));
  }
  return static_cast<int>(residual_out<T>(y3, s3, ys, ss, a->x, a->out, b.rows2, C4, st));
}

template <typename T>
static int bottleneck_bwd_impl(const BotArgs<T>* a, void* ws, size_t* ws_bytes, cudaStream_t st) {
  using sm90::Epilogue;
  const BotGeoms b = bot_geoms(a);
  const int P = b.P, C4 = b.C4, n = a->n, hi = a->hi, wi = a->wi, s = a->stride;
  const int ho = hi / s, wo = wi / s;
  // every convolution of the backward as a plan of the pipelined core: the
  // recomputed forward's, then the data gradients'
  const sm90::ConvPlan &r1 = b.r1, &r2 = b.r2, &r3 = b.r3, &rs = b.rs;
  const sm90::ConvPlan d3 = sm90::forward_plan(n, ho, wo, C4, 1, 1, P);  // dy3 k3^T
  const sm90::ConvPlan d2 = sm90::transposed3_plan(n, ho, wo, P, hi, wi, P, s);
  const sm90::ConvPlan d1 = sm90::pointwise_dx_plan(n, hi, wi, P, a->cin, s);  // dy1 k1^T
  const sm90::ConvPlan dsx = sm90::shortcut_dx_plan(n, ho, wo, C4, hi, wi, a->cin, s);
  Arena ar{static_cast<char*>(ws)};
  // pre-BN y in fp32 (the BN backward's yhat and masks) and, for the next
  // conv, a = rnd(relu(y * scale + shift)) in the compute dtype
  float* y1 = ar.take((size_t)b.rows1 * P);
  T* a1 = take_as<T>(ar, (size_t)b.rows1 * P);
  float* y2 = ar.take((size_t)b.rows2 * P);
  T* a2 = take_as<T>(ar, (size_t)b.rows2 * P);
  float* y3 = ar.take((size_t)b.rows2 * C4);
  float* ys = a->proj ? ar.take((size_t)b.rows2 * C4) : nullptr;
  // the cotangents in the compute dtype
  T* dz = take_as<T>(ar, (size_t)b.rows2 * C4);
  T* dy3 = compute_copy<T>(ar, y3, (size_t)b.rows2 * C4);
  T* dys = a->proj ? compute_copy<T>(ar, ys, (size_t)b.rows2 * C4) : nullptr;
  float* da2 = ar.take((size_t)b.rows2 * P);
  T* dy2 = compute_copy<T>(ar, da2, (size_t)b.rows2 * P);
  float* da1 = ar.take((size_t)b.rows1 * P);
  T* dy1 = compute_copy<T>(ar, da1, (size_t)b.rows1 * P);
  float* tmp = ar.take(C4);
  BnScratch s1 = bn_scratch(ar, b.rows1, P);
  BnScratch s2 = bn_scratch(ar, b.rows2, P);
  BnScratch s3 = bn_scratch(ar, b.rows2, C4);
  BnScratch ss = bn_scratch(ar, b.rows2, C4);
  size_t wpart = max_sz(max_sz(sm90::wgrad_part_floats<T>(r1), sm90::wgrad_part_floats<T>(r2)),
                        sm90::wgrad_part_floats<T>(r3));
  if (a->proj) wpart = max_sz(wpart, sm90::wgrad_part_floats<T>(rs));
  float* part = ar.take(wpart);
  // the shortcut's share of dx, summed into dx by the last conv's epilogue
  float* dxs = a->proj ? staged(ar, a->dx, (size_t)b.rows1 * a->cin) : nullptr;
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  // recompute the forward from the saved moments
  CHECK(fold_saved(s1, a->m1, a->v1, a->g1, a->b1, a->eps, P, st));
  CHECK(fold_saved(s2, a->m2, a->v2, a->g2, a->b2, a->eps, P, st));
  CHECK(fold_saved(s3, a->m3, a->v3, a->g3, a->b3, a->eps, C4, st));
  CHECK(sm90::conv_gemm(r1, a->x, a->k1,
                        Epilogue<T, float, float>{y1, nullptr, a1, s1.scale, s1.shift}, st));
  CHECK(sm90::conv_gemm(r2, a1, a->k2,
                        Epilogue<T, float, float>{y2, nullptr, a2, s2.scale, s2.shift}, st));
  CHECK(sm90::conv_gemm(r3, a2, a->k3, Epilogue<T, float, float>{y3, nullptr, nullptr, kNone, kNone},
                        st));
  if (a->proj) {
    CHECK(fold_saved(ss, a->ms, a->vs, a->gs, a->bs, a->eps, C4, st));
    CHECK(sm90::conv_gemm(rs, a->x, a->ks,
                          Epilogue<T, float, float>{ys, nullptr, nullptr, kNone, kNone}, st));
  }
  // stage 3 in two passes: dz and the sums (z stays in registers), then
  // dy3 and dyS
  CHECK(residual_bn_bwd<T>(y3, a->m3, s3, a->g3, a->db3, a->dg3, dy3, ys, a->ms, ss, a->gs,
                           a->dbs, a->dgs, dys, a->x, a->gout, dz, tmp, b.rows2, C4, st));
  CHECK(wgrad_sm90(r3, a2, dy3, part, a->dk3, st));
  if (a->proj) CHECK(wgrad_sm90(rs, a->x, dys, part, a->dks, st));
  // stage 2: da2 = dy3 k3^T, then its BN backward (dp2 in place, dy2)
  CHECK(sm90::conv_gemm(d3, dy3, a->k3t,
                        Epilogue<T, float, float>{da2, nullptr, nullptr, kNone, kNone}, st));
  CHECK(bwd_sums(da2, nullptr, y2, a->m2, s2, a->g2, a->b2, da2, a->db2, a->dg2, b.rows2, P, st));
  CHECK(bwd_apply(da2, y2, a->m2, s2, a->g2, a->db2, a->dg2, dy2, b.rows2, P, st));
  CHECK(wgrad_sm90(r2, a1, dy2, part, a->dk2, st));
  // stage 1: da1 = the transposed 3x3/s of dy2 (by parity class at s = 2)
  CHECK(sm90::conv_gemm(d2, dy2, a->k2t,
                        Epilogue<T, float, float>{da1, nullptr, nullptr, kNone, kNone}, st));
  CHECK(bwd_sums(da1, nullptr, y1, a->m1, s1, a->g1, a->b1, da1, a->db1, a->dg1, b.rows1, P, st));
  CHECK(bwd_apply(da1, y1, a->m1, s1, a->g1, a->db1, a->dg1, dy1, b.rows1, P, st));
  CHECK(wgrad_sm90(r1, a->x, dy1, part, a->dk1, st));
  // dx = dy1 k1^T + dz (identity) or + the shortcut's share dyS ks^T,
  // which at s = 2 lands on the even-even pixels only
  if (a->proj) {
    CHECK(sm90::conv_gemm(dsx, dys, a->kst,
                          Epilogue<T, float, float>{dxs, nullptr, nullptr, kNone, kNone}, st));
    CHECK(sm90::conv_gemm(d1, dy1, a->k1t,
                          Epilogue<T, T, float>{a->dx, dxs, nullptr, kNone, kNone}, st));
  } else {
    CHECK(sm90::conv_gemm(d1, dy1, a->k1t, Epilogue<T, T, T>{a->dx, dz, nullptr, kNone, kNone},
                          st));
  }
  return 0;
}


// One argument block for the four BasicBlock entry points; the entry point
// decides the shortcut (basic_*: x itself, stride 1, cin == c; proj_*: the
// 1x1/stride conv + BN). Kernels: k1 HWIO [3, 3, cin, c], k2 [3, 3, c, c],
// ks [cin, c] (projection only); the backward also takes k1t [3, 3, c, cin]
// and k2t [3, 3, c, c] (the channel axes swapped) and kst [c, cin]. The
// moments are written by the forward and read by the backward.
template <typename T>
struct BlockArgs {
  const T* x;  // [n, hi, wi, cin]
  const T* k1;
  const T* k2;
  const T* ks;
  const T* k1t;
  const T* k2t;
  const T* kst;
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const float* gs;
  const float* bs;
  const T* gout;  // backward: [n, ho, wo, c]
  T* out;         // forward: [n, ho, wo, c]
  float* m1;
  float* v1;
  float* m2;
  float* v2;
  float* ms;
  float* vs;
  T* dx;
  T* dk1;
  T* dk2;
  T* dks;
  float* dg1;
  float* db1;
  float* dg2;
  float* db2;
  float* dgs;
  float* dbs;
  int n, hi, wi, cin, c, stride;
  float eps;
};

// The BasicBlock's forward convolutions as plans of the pipelined core,
// which both entry points run them on, and its rows.
struct BlockGeoms {
  sm90::ConvPlan r1, r2, rs;  // conv3x3/s(x, k1), conv3x3(a1, k2), conv1x1/s(x, ks)
  int rows;                   // n * ho * wo: every BN of the block counts over it
};

template <typename T>
static BlockGeoms block_geoms(const BlockArgs<T>* a) {
  BlockGeoms b;
  const int s = a->stride, ho = a->hi / s, wo = a->wi / s;
  b.r1 = sm90::forward_plan(a->n, a->hi, a->wi, a->cin, 3, s, a->c);
  b.r2 = sm90::forward_plan(a->n, ho, wo, a->c, 3, 1, a->c);
  b.rs = sm90::forward_plan(a->n, a->hi, a->wi, a->cin, 1, s, a->c);
  b.rows = a->n * ho * wo;
  return b;
}

// The BasicBlock forward on the pipelined core: the Bottleneck forward's
// schedule with the block's convs. y1 = conv3x3/s(x, k1) through the
// statistics epilogue, finalize, a1 = rnd(relu(y1 * s1 + t1)) in the
// compute dtype; y2 = conv3x3(a1, k2) with statistics, finalize;
// (projection) yS = conv1x1/s(x, ks) with statistics, finalize; then out
// = rnd(relu(y2 * s2 + t2 + (yS * sS + tS | x))) in one pass. a1 comes
// from the same plan, K order and fmaf as the backward's recomputed a1, so
// the two are bitwise equal.
template <typename T>
static int block_fwd(const BlockArgs<T>* a, bool proj, void* ws, size_t* ws_bytes,
                     cudaStream_t st) {
  const BlockGeoms b = block_geoms(a);
  const int C = a->c, rows = b.rows;
  const size_t count = (size_t)rows * C;
  Arena ar{static_cast<char*>(ws)};
  // pre-BN y1 in fp32 and a1 in the compute dtype (over y1 under fp32)
  float* y1 = ar.take(count);
  T* a1 = compute_copy<T>(ar, y1, count);
  float* ys = proj ? ar.take(count) : nullptr;
  BnScratch s1 = bn_scratch(ar, rows, C);
  BnScratch s2 = bn_scratch(ar, rows, C);
  BnScratch ss = bn_scratch(ar, rows, C);
  // y2 is staged in out and the last pass runs in place (fp32)
  float* y2 = staged(ar, a->out, count);
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  CHECK(sm90::conv_gemm(b.r1, a->x, a->k1, with_stats<T>(y1, s1), st));
  CHECK(finalize(s1, rows, C, a->g1, a->b1, a->eps, a->m1, a->v1, st));
  CHECK(activate(y1, s1, a1, rows, C, st));
  CHECK(sm90::conv_gemm(b.r2, a1, a->k2, with_stats<T>(y2, s2), st));
  CHECK(finalize(s2, rows, C, a->g2, a->b2, a->eps, a->m2, a->v2, st));
  if (proj) {
    CHECK(sm90::conv_gemm(b.rs, a->x, a->ks, with_stats<T>(ys, ss), st));
    CHECK(finalize(ss, rows, C, a->gs, a->bs, a->eps, a->ms, a->vs, st));
  }
  return static_cast<int>(residual_out<T>(y2, s2, ys, ss, a->x, a->out, rows, C, st));
}

// The BasicBlock backward on the pipelined core: the Bottleneck backward's
// schedule with the block's convs. Recompute y1 = conv3x3/s(x, k1) with a1 =
// rnd(relu(y1 * s1 + t1)) in its epilogue, y2 = conv3x3(a1, k2) and
// (projection) yS = conv1x1/s(x, ks); stage 2 in two passes (dz, the sums,
// then dy2 and dyS in the compute dtype) and dk2, dks; stage 1 da1 = the
// transposed 3x3 of dy2, its BN backward into dy1, dk1 over x; dx = the
// transposed 3x3/s of dy1 (by parity class at s = 2) plus dz (identity) or
// the shortcut's share dyS ks^T, which at s = 2 lands on the even-even
// pixels only, so only class (0, 0) adds it.
template <typename T>
static int block_bwd(const BlockArgs<T>* a, bool proj, void* ws, size_t* ws_bytes,
                     cudaStream_t st) {
  using sm90::Epilogue;
  const BlockGeoms b = block_geoms(a);
  const int n = a->n, hi = a->hi, wi = a->wi, cin = a->cin, C = a->c, s = a->stride;
  const int ho = hi / s, wo = wi / s, rows = b.rows;
  const size_t count = (size_t)rows * C;
  // every convolution of the backward as a plan of the pipelined core: the
  // recomputed forward's, then the data gradients'
  const sm90::ConvPlan &r1 = b.r1, &r2 = b.r2, &rs = b.rs;
  const sm90::ConvPlan d2 = sm90::transposed3_plan(n, ho, wo, C, ho, wo, C, 1);  // dy2 k2^T
  const sm90::ConvPlan d1 = sm90::transposed3_plan(n, ho, wo, C, hi, wi, cin, s, proj);
  const sm90::ConvPlan dsx = sm90::shortcut_dx_plan(n, ho, wo, C, hi, wi, cin, s);
  Arena ar{static_cast<char*>(ws)};
  // pre-BN y in fp32 (the BN backward's yhat and masks) and a1 in the
  // compute dtype
  float* y1 = ar.take(count);
  T* a1 = take_as<T>(ar, count);
  float* y2 = ar.take(count);
  float* ys = proj ? ar.take(count) : nullptr;
  // the cotangents in the compute dtype
  T* dz = take_as<T>(ar, count);
  T* dy2 = compute_copy<T>(ar, y2, count);
  T* dys = proj ? compute_copy<T>(ar, ys, count) : nullptr;
  float* da1 = ar.take(count);
  T* dy1 = compute_copy<T>(ar, da1, count);
  float* tmp = ar.take(C);
  BnScratch s1 = bn_scratch(ar, rows, C);
  BnScratch s2 = bn_scratch(ar, rows, C);
  BnScratch ss = bn_scratch(ar, rows, C);
  size_t wpart = max_sz(sm90::wgrad_part_floats<T>(r1), sm90::wgrad_part_floats<T>(r2));
  if (proj) wpart = max_sz(wpart, sm90::wgrad_part_floats<T>(rs));
  float* part = ar.take(wpart);
  // the shortcut's share of dx, summed into dx by the last conv's epilogue
  float* dxs = proj ? staged(ar, a->dx, (size_t)n * hi * wi * cin) : nullptr;
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  // recompute the forward from the saved moments
  CHECK(fold_saved(s1, a->m1, a->v1, a->g1, a->b1, a->eps, C, st));
  CHECK(fold_saved(s2, a->m2, a->v2, a->g2, a->b2, a->eps, C, st));
  CHECK(sm90::conv_gemm(r1, a->x, a->k1,
                        Epilogue<T, float, float>{y1, nullptr, a1, s1.scale, s1.shift}, st));
  CHECK(sm90::conv_gemm(r2, a1, a->k2, Epilogue<T, float, float>{y2, nullptr, nullptr, kNone, kNone},
                        st));
  if (proj) {
    CHECK(fold_saved(ss, a->ms, a->vs, a->gs, a->bs, a->eps, C, st));
    CHECK(sm90::conv_gemm(rs, a->x, a->ks,
                          Epilogue<T, float, float>{ys, nullptr, nullptr, kNone, kNone}, st));
  }
  // stage 2 in two passes: dz and the sums (z stays in registers), then
  // dy2 and dyS
  CHECK(residual_bn_bwd<T>(y2, a->m2, s2, a->g2, a->db2, a->dg2, dy2, ys, a->ms, ss, a->gs,
                           a->dbs, a->dgs, dys, a->x, a->gout, dz, tmp, rows, C, st));
  CHECK(wgrad_sm90(r2, a1, dy2, part, a->dk2, st));
  if (proj) CHECK(wgrad_sm90(rs, a->x, dys, part, a->dks, st));
  // stage 1: da1 = the transposed 3x3 of dy2, then its BN backward (dp1 in
  // place, dy1)
  CHECK(sm90::conv_gemm(d2, dy2, a->k2t,
                        Epilogue<T, float, float>{da1, nullptr, nullptr, kNone, kNone}, st));
  CHECK(bwd_sums(da1, nullptr, y1, a->m1, s1, a->g1, a->b1, da1, a->db1, a->dg1, rows, C, st));
  CHECK(bwd_apply(da1, y1, a->m1, s1, a->g1, a->db1, a->dg1, dy1, rows, C, st));
  CHECK(wgrad_sm90(r1, a->x, dy1, part, a->dk1, st));
  // dx = dy1 k1^T + dz (identity) or + the shortcut's share dyS ks^T
  if (proj) {
    CHECK(sm90::conv_gemm(dsx, dys, a->kst,
                          Epilogue<T, float, float>{dxs, nullptr, nullptr, kNone, kNone}, st));
    CHECK(sm90::conv_gemm(d1, dy1, a->k1t,
                          Epilogue<T, T, float>{a->dx, dxs, nullptr, kNone, kNone}, st));
  } else {
    CHECK(sm90::conv_gemm(d1, dy1, a->k1t, Epilogue<T, T, T>{a->dx, dz, nullptr, kNone, kNone},
                          st));
  }
  return 0;
}

extern "C" {

// The entry points: each fp32 one and its bf16 twin run the same sequence.
#define ENTRY(name, impl, Args)                                                   \
  int name(const Args<float>* a, void* ws, size_t* ws_bytes, void* stream) {      \
    return impl(a, ws, ws_bytes, static_cast<cudaStream_t>(stream));              \
  }                                                                               \
  int name##_bf16(const Args<bf16>* a, void* ws, size_t* ws_bytes, void* stream) { \
    return impl(a, ws, ws_bytes, static_cast<cudaStream_t>(stream));              \
  }

ENTRY(stem_fwd, stem_fwd_impl, StemArgs)
ENTRY(stem_bwd, stem_bwd_impl, StemArgs)
ENTRY(bottleneck_fwd, bottleneck_fwd_impl, BotArgs)
ENTRY(bottleneck_bwd, bottleneck_bwd_impl, BotArgs)
#undef ENTRY

#define BLOCK_ENTRY(name, fn, proj)                                                    \
  int name(const BlockArgs<float>* a, void* ws, size_t* ws_bytes, void* stream) {      \
    return fn(a, proj, ws, ws_bytes, static_cast<cudaStream_t>(stream));               \
  }                                                                                    \
  int name##_bf16(const BlockArgs<bf16>* a, void* ws, size_t* ws_bytes, void* stream) { \
    return fn(a, proj, ws, ws_bytes, static_cast<cudaStream_t>(stream));               \
  }

BLOCK_ENTRY(basic_fwd, block_fwd, false)
BLOCK_ENTRY(basic_bwd, block_bwd, false)
BLOCK_ENTRY(proj_fwd, block_fwd, true)
BLOCK_ENTRY(proj_bwd, block_bwd, true)
#undef BLOCK_ENTRY

}  // extern "C"
