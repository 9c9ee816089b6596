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
// on the pipelined core (below); only the stem keeps the first design.
//
// Design: phases become kernels. The Pallas kernels walk a sequential
// phase-major grid (phases, batch tiles) and carry BN sums from tile to
// tile in VMEM scratch. CTAs on Hopper run in no order, so each entry point
// is a sequence of kernels on the caller's stream. The first design's,
// which the stem runs:
//   - conv_gemm_kernel: an implicit-GEMM 3x3 convolution (forward gather,
//     or the stride-1 transposed gather of the data gradient) with an
//     optional statistics epilogue that writes each CTA's per-channel tile
//     mean and centred sum of squares to a [tiles, C] partial buffer;
//   - bn_finalize_kernel: combines the partials in a fixed order, in fp64,
//     around a per-channel shift (the first tile's mean), so the variance
//     suffers no E[y^2] - E[y]^2 cancellation and repeated runs are
//     bitwise identical; then folds gamma/beta into scale/shift;
//   - bn_apply_kernel: the normalize + ReLU pass;
//   - conv_wgrad_kernel + split_reduce_kernel: the weight gradient as a
//     GEMM over rows split across CTAs, with a fixed-order fp64 combine;
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
// alone keeps the first design's launch sequence.

// Stage, not recompute, inside a call: a call keeps its pre-BN
// intermediates (y1, y2, y3, yS) in a workspace the wrapper allocates with
// torch.empty and frees on return. Across forward -> backward the op's
// contract is the Pallas one: only x, the weights and the O(C) moments are
// saved, so the backward recomputes the forward convolutions once (one
// extra forward's FLOPs) and then stages its own intermediates. The Pallas
// kernels recompute every conv in every phase because VMEM cannot hold a
// batch of activations; HBM can, and re-running a conv costs far more
// FLOPs than writing and reading its output once.
//
// What bounds it on the H100. Fp32 FMA on the CUDA cores (no TF32, no
// tensor cores, no fast-math), so the fp32 convolutions are bound by the
// 67 TFLOP/s non-tensor fp32 rate: a recipe-shape Bottleneck forward is
// ~83 GFLOP against ~3 GB of activations, a recipe-shape ResNet-18 block
// 60-77 GFLOP. The stem and the elementwise BN passes are bound by bytes.
// The first design's conv_gemm_kernel is a shared-memory tiled GEMM (128 x
// 64 output tile per CTA, each thread an 8 x 4 register micro-tile, 16-deep
// K chunks, one stage); the redesigned core's fp32 kernels take 128 x 128
// tiles, 8 x 8 micro-tiles fed by 16-byte shared loads and a three-stage
// cp.async ring. Each BN pass is one read and one write of its tensor.
//
// Shared memory of the first design's kernels is static (under 17 KB per
// CTA); the redesigned core's is dynamic (43-55 KB fp32, 96-128 KB bf16,
// set with cudaFuncSetAttribute) and, like the first design's,
// independent of the geometry, so the Hopper admission gate
// (ops/fused_conv.py supports_*) needs only the geometric rules and the
// 32-bit row-index range.
//
// bf16 compute (the *_bf16 entry points, the Pallas kernels run with a
// bf16 compute dtype). x, the kernels, the upstream gradient, out, dx and
// every dW are bf16; the moments, gamma/beta and their gradients stay
// fp32. Every convolution rounds its operands to bf16 and multiplies them
// on the tensor cores with fp32 accumulation: in the stem, the first
// design's kernels (mma.sync m16n8k16) conv_gemm_bf16_kernel (the implicit
// GEMM, same gathers and epilogues as conv_gemm_kernel) and
// conv_wgrad_bf16_kernel (the row-split weight gradient); in every block
// entry point, wgmma on the redesigned core. The rounding points
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
// passes by bytes. The first design answers neither: each 32-deep chunk is
// gathered by the loading threads and stored through shared memory with
// no pipelining and no wgmma/TMA; the redesign answers the
// first with wgmma on a three-stage cp.async ring and the second with
// two-byte operands and cotangents, a pass fewer in the backward and 4-wide
// passes (PERF.md has the times of both designs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "conv_gemm_sm90.cuh"

namespace {

constexpr int THREADS = 256;
// conv_gemm_kernel tile: BM output rows x BN output channels, BK deep
constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
// conv_wgrad_kernel tile: WK weight rows x WN channels, WM-row chunks
constexpr int WK = 64, WN = 64, WM = 16;
// rows per CTA of the per-channel elementwise kernels (block 32 x 8)
constexpr int EW_ROWS = 128;
constexpr int WAVES = sm90::WGRAD_CTAS;  // CTAs the weight-gradient split aims for

// bf16 tiles (conv_gemm_bf16_kernel, conv_wgrad_bf16_kernel): the same
// 128 x 64 output tile, 32-deep K chunks; weight gradient 64 x 64 per
// CTA over 32-row chunks. Shared-memory rows hold HLD bf16 (the chunk plus
// 8 of padding: 80 bytes, so the fragment loads of a warp hit 32 distinct
// banks).
constexpr int HBK = 32, HWM = 32, HLD = 40;
static_assert(BM == 128 && BN == 64, "the bf16 conv tile is 128 x 64");
// bn_finalize_kernel counts min(BM, rows - t * BM) rows in tile t, for the
// first design's partials and for the pipelined core's statistics epilogue
static_assert(sm90::GEMM_BM == BM, "one tile height for every statistics partial");

using bf16 = __nv_bfloat16;

struct ConvGeom {
  int n, hi, wi, cin;  // the tensor the gather reads
  int ho, wo, cout;    // the GEMM's row grid (n * ho * wo rows) and columns
  int ks, stride, pad;
};

using sm90::from_f;  // float -> float or bf16 (round to nearest)
using sm90::to_f;    // float or bf16 -> float

// The source pixel of GEMM row (n, oh, ow) at kernel offset (kh, kw).
// Forward: the conv reads padded input stride * o + d, i.e. unpadded
// stride * o - pad + d. Transposed (the stem's data gradient, stride 1):
// the rows are the forward conv's input grid, the source is dy, and a row
// takes dy[o] where o - pad + kh == its index.
template <bool TRANS>
__device__ __forceinline__ bool src_pixel(const ConvGeom& g, int oh, int ow,
                                          int kh, int kw, int& ih, int& iw) {
  if (!TRANS) {
    ih = oh * g.stride - g.pad + kh;
    iw = ow * g.stride - g.pad + kw;
  } else {
    ih = oh + g.pad - kh;
    iw = ow + g.pad - kw;
  }
  return ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi;
}

// Four consecutive GEMM-K entries k .. k+3 of row (n, oh, ow): the im2col
// value; zero outside the image or past K. With cin % 4 == 0 the four
// share one pixel: one 16-byte load.
template <bool TRANS>
__device__ __forceinline__ float4 load_a4(const float* src, const ConvGeom& g,
                                          bool row_ok, int n, int oh, int ow,
                                          int k, int K, bool vec) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (row_ok) {
    if (vec) {
      if (k < K) {
        const int ci = k % g.cin, t = k / g.cin;
        const int kw = t % g.ks, kh = t / g.ks;
        int ih, iw;
        if (src_pixel<TRANS>(g, oh, ow, kh, kw, ih, iw)) {
          const float4 q = *reinterpret_cast<const float4*>(
              src + (((size_t)n * g.hi + ih) * g.wi + iw) * g.cin + ci);
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k + e;
        if (kk >= K) break;
        const int ci = kk % g.cin, t = kk / g.cin;
        const int kw = t % g.ks, kh = t / g.ks;
        int ih, iw;
        if (src_pixel<TRANS>(g, oh, ow, kh, kw, ih, iw))
          v[e] = src[(((size_t)n * g.hi + ih) * g.wi + iw) * g.cin + ci];
      }
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// out[m, c] = sum_k A[m, k] * wt[k, c], with A the implicit im2col matrix
// of src. Optional statistics of out per CTA tile: part_mean[blockIdx.x, c]
// and part_m2[blockIdx.x, c] (centred on the tile mean, over the tile's
// valid rows).
template <bool TRANS>
__global__ void __launch_bounds__(THREADS) conv_gemm_kernel(
    const float* __restrict__ src, const float* __restrict__ wt,
    float* out, float* __restrict__ part_mean,
    float* __restrict__ part_m2, ConvGeom g) {
  __shared__ float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float red[16][BN + 1];
  __shared__ float tmean[BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A loader: one row, eight consecutive k
  const int ar = tid >> 1, ak = (tid & 1) * 8;
  const int am = m0 + ar;
  const bool arow = am < M;
  int an = 0, aoh = 0, aow = 0;
  if (arow) {
    const int hw = g.ho * g.wo;
    an = am / hw;
    const int r = am - an * hw;
    aoh = r / g.wo;
    aow = r - aoh * g.wo;
  }
  // B loader: one k, four consecutive channels
  const int bk = tid >> 4, bc = (tid & 15) * 4;
  const bool vec = (g.cin % 4) == 0;
  const bool bvec = (g.cout % 4) == 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      const float4 a = load_a4<TRANS>(src, g, arow, an, aoh, aow, k0 + ak + q, K, vec);
      As[ak + q + 0][ar] = a.x;
      As[ak + q + 1][ar] = a.y;
      As[ak + q + 2][ar] = a.z;
      As[ak + q + 3][ar] = a.w;
    }
    {
      const int k = k0 + bk, c = n0 + bc;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K) {
        const float* row = wt + (size_t)k * g.cout;
        if (bvec) {
          if (c < g.cout) b = *reinterpret_cast<const float4*>(row + c);
        } else {
          if (c + 0 < g.cout) b.x = row[c + 0];
          if (c + 1 < g.cout) b.y = row[c + 1];
          if (c + 2 < g.cout) b.z = row[c + 2];
          if (c + 3 < g.cout) b.w = row[c + 3];
        }
      }
      *reinterpret_cast<float4*>(&Bs[bk][bc]) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= g.cout) continue;
      out[(size_t)m * g.cout + c] = acc[i][j];
    }
  }

  if (part_mean) {
    const int rows = min(BM, M - m0);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (m0 + ty + 16 * i < M) s += acc[i][j];
      red[ty][tx + 16 * j] = s;
    }
    __syncthreads();
    if (tid < BN) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += red[t][tid];
      tmean[tid] = s / (float)rows;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float mu = tmean[tx + 16 * j];
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (m0 + ty + 16 * i < M) {
          const float d = acc[i][j] - mu;
          q = fmaf(d, d, q);
        }
      red[ty][tx + 16 * j] = q;
    }
    __syncthreads();
    if (tid < BN && n0 + tid < g.cout) {
      float q = 0.f;
      for (int t = 0; t < 16; ++t) q += red[t][tid];
      const size_t o = (size_t)blockIdx.x * g.cout + n0 + tid;
      part_mean[o] = tmean[tid];
      part_m2[o] = q;
    }
  }
}

// part[z, k, c] = sum over rows m of split z of A[m, k] * dy[m, c]: the
// weight gradient, A the im2col of src in forward gather.
__global__ void __launch_bounds__(THREADS) conv_wgrad_kernel(
    const float* __restrict__ src, const float* __restrict__ dy,
    float* __restrict__ part, ConvGeom g, int m_per) {
  __shared__ __align__(16) float As[WM][WK + 4];
  __shared__ __align__(16) float Ds[WM][WN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int k0 = blockIdx.x * WK, c0 = blockIdx.y * WN;
  const int mb = blockIdx.z * m_per;
  const int me = min(M, mb + m_per);
  const int lm = tid / 16, lk = (tid % 16) * 4;
  const bool vec = (g.cin % 4) == 0;
  const bool dvec = (g.cout % 4) == 0;
  const int hw = g.ho * g.wo;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = mb; m0 < me; m0 += WM) {
    const int m = m0 + lm;
    const bool ok = m < me;
    int n = 0, oh = 0, ow = 0;
    if (ok) {
      n = m / hw;
      const int r = m - n * hw;
      oh = r / g.wo;
      ow = r - oh * g.wo;
    }
    *reinterpret_cast<float4*>(&As[lm][lk]) =
        load_a4<false>(src, g, ok, n, oh, ow, k0 + lk, K, vec);
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const int c = c0 + lk;
      const float* row = dy + (size_t)m * g.cout;
      if (dvec) {
        if (c < g.cout) d = *reinterpret_cast<const float4*>(row + c);
      } else {
        if (c + 0 < g.cout) d.x = row[c + 0];
        if (c + 1 < g.cout) d.y = row[c + 1];
        if (c + 2 < g.cout) d.z = row[c + 2];
        if (c + 3 < g.cout) d.w = row[c + 3];
      }
    }
    *reinterpret_cast<float4*>(&Ds[lm][lk]) = d;
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < WM; ++mm) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ds[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < g.cout) part[((size_t)blockIdx.z * K + k) * g.cout + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 operands on the tensor cores.
// ---------------------------------------------------------------------------

// d += a * b over one 16 x 8 x 16 tile: bf16 operands, fp32 accumulators.
// Fragments (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4): a holds
// A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b holds
// B[2t..2t+1][g], B[2t+8..2t+9][g]; d holds D[g][2t..2t+1], D[g+8][2t..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 in one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Eight consecutive GEMM-K entries k .. k+7 of row (n, oh, ow), as floats:
// load_a4 twice for an fp32 source.
template <bool TRANS>
__device__ __forceinline__ void load_a8(const float* src, const ConvGeom& g,
                                        bool row_ok, int n, int oh, int ow,
                                        int k, int K, float (&v)[8]) {
  const bool vec = (g.cin % 4) == 0;
  const float4 a = load_a4<TRANS>(src, g, row_ok, n, oh, ow, k, K, vec);
  const float4 b = load_a4<TRANS>(src, g, row_ok, n, oh, ow, k + 4, K, vec);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The same from a bf16 source: with cin % 8 == 0 the eight share one
// pixel, one 16-byte load.
template <bool TRANS>
__device__ __forceinline__ void load_a8(const bf16* src, const ConvGeom& g,
                                        bool row_ok, int n, int oh, int ow,
                                        int k, int K, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (!row_ok) return;
  if ((g.cin % 8) == 0) {
    if (k >= K) return;
    const int ci = k % g.cin, t = k / g.cin;
    const int kw = t % g.ks, kh = t / g.ks;
    int ih, iw;
    if (!src_pixel<TRANS>(g, oh, ow, kh, kw, ih, iw)) return;
    const uint4 q = *reinterpret_cast<const uint4*>(
        src + (((size_t)n * g.hi + ih) * g.wi + iw) * g.cin + ci);
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = to_f(h[e]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int kk = k + e;
    if (kk >= K) break;
    const int ci = kk % g.cin, t = kk / g.cin;
    const int kw = t % g.ks, kh = t / g.ks;
    int ih, iw;
    if (src_pixel<TRANS>(g, oh, ow, kh, kw, ih, iw))
      v[e] = to_f(src[(((size_t)n * g.hi + ih) * g.wi + iw) * g.cin + ci]);
  }
}

// Eight consecutive columns c .. c+7 of row r of a [rows, cols] matrix
// (zero past rows_end or cols), as floats.
__device__ __forceinline__ void load_row8(const bf16* m, int r, int rows_end,
                                          int c, int cols, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (r >= rows_end) return;
  const bf16* row = m + (size_t)r * cols;
  if ((cols % 8) == 0) {
    if (c < cols) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + c);
      const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = to_f(h[e]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < cols) v[e] = to_f(row[c + e]);
}

__device__ __forceinline__ void load_row8(const float* m, int r, int rows_end,
                                          int c, int cols, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (r >= rows_end) return;
  const float* row = m + (size_t)r * cols;
  if ((cols % 4) == 0) {
#pragma unroll
    for (int h = 0; h < 8; h += 4)
      if (c + h < cols) {
        const float4 q = *reinterpret_cast<const float4*>(row + c + h);
        v[h] = q.x; v[h + 1] = q.y; v[h + 2] = q.z; v[h + 3] = q.w;
      }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < cols) v[e] = row[c + e];
}

// conv_gemm_kernel with bf16 operands on the tensor cores: out[m, c] =
// sum_k bf16(A[m, k]) * wt[k, c] with fp32 accumulation,
// A the implicit im2col matrix of src (bf16 x, or an fp32 staged tensor
// rounded as it is loaded). K is walked in
// 32-deep chunks, zero past K (the stem's 27). Eight warps, each a 32 x 32
// quarter-column of the 128 x 64 tile: 2 x 4 mma tiles. The accumulators
// are staged through shared memory for coalesced stores and for the
// per-CTA statistics, which are conv_gemm_kernel's (tile mean and centred
// sum of squares of the fp32 accumulators over the valid rows).
template <bool TRANS, typename SrcT, typename OutT>
__global__ void __launch_bounds__(THREADS) conv_gemm_bf16_kernel(
    const SrcT* __restrict__ src, const bf16* __restrict__ wt,
    OutT* out, float* __restrict__ part_mean,
    float* __restrict__ part_m2, ConvGeom g) {
  // the A and B chunks during the K loop; the fp32 tile after it
  __shared__ __align__(16) unsigned char smem[BM * (BN + 4) * sizeof(float)];
  __shared__ float red[4][BN];
  __shared__ float tmean[BN];
  bf16 (*As)[HLD] = reinterpret_cast<bf16 (*)[HLD]>(smem);                // [BM][HLD]
  bf16 (*Bs)[HLD] = reinterpret_cast<bf16 (*)[HLD]>(smem + BM * HLD * 2);  // [BN][HLD], k inner
  float (*Cs)[BN + 4] = reinterpret_cast<float (*)[BN + 4]>(smem);       // [BM][BN + 4]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  const int M = g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A loader: one row, sixteen consecutive k
  const int ar = tid >> 1, ak = (tid & 1) * 16;
  const int am = m0 + ar;
  const bool arow = am < M;
  int an = 0, aoh = 0, aow = 0;
  if (arow) {
    const int hw = g.ho * g.wo;
    an = am / hw;
    const int r = am - an * hw;
    aoh = r / g.wo;
    aow = r - aoh * g.wo;
  }
  // B loader: one k, eight consecutive channels
  const int bk = tid >> 3, bc = (tid & 7) * 8;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += HBK) {
#pragma unroll
    for (int q = 0; q < 16; q += 8) {
      float v[8];
      load_a8<TRANS>(src, g, arow, an, aoh, aow, k0 + ak + q, K, v);
      *reinterpret_cast<uint4*>(&As[ar][ak + q]) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
    {
      float w[8];
      load_row8(wt, k0 + bk, K, n0 + bc, g.cout, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[bc + j][bk] = __float2bfloat16_rn(w[j]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + gq;
        af[i][0] = ld32(&As[r][kk + 2 * tq]);
        af[i][1] = ld32(&As[r + 8][kk + 2 * tq]);
        af[i][2] = ld32(&As[r][kk + 2 * tq + 8]);
        af[i][3] = ld32(&As[r + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + gq;
        bfr[j][0] = ld32(&Bs[c][kk + 2 * tq]);
        bfr[j][1] = ld32(&Bs[c][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + i * 16 + gq, c = wn + j * 8 + 2 * tq;
      Cs[r][c] = acc[i][j][0];
      Cs[r][c + 1] = acc[i][j][1];
      Cs[r + 8][c] = acc[i][j][2];
      Cs[r + 8][c + 1] = acc[i][j][3];
    }
  __syncthreads();

  const int rows = min(BM, M - m0);
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (r >= rows || n0 + c >= g.cout) continue;
    out[(size_t)(m0 + r) * g.cout + n0 + c] = from_f<OutT>(Cs[r][c]);
  }

  if (part_mean) {
    const int c = tid % BN, q = tid / BN;
    float s = 0.f;
    for (int r = q; r < rows; r += 4) s += Cs[r][c];
    red[q][c] = s;
    __syncthreads();
    if (tid < BN) tmean[tid] = (red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid]) / (float)rows;
    __syncthreads();
    const float mu = tmean[c];
    float m2 = 0.f;
    for (int r = q; r < rows; r += 4) {
      const float d = Cs[r][c] - mu;
      m2 = fmaf(d, d, m2);
    }
    red[q][c] = m2;
    __syncthreads();
    if (tid < BN && n0 + tid < g.cout) {
      const size_t o = (size_t)blockIdx.x * g.cout + n0 + tid;
      part_mean[o] = tmean[tid];
      part_m2[o] = red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
    }
  }
}

// conv_wgrad_kernel with bf16 operands on the tensor cores: part[z, k, c] =
// sum over rows m of split z of A[m, k] * bf16(dy[m, c]), fp32
// accumulation; A the im2col of the bf16 src in forward gather, dy the
// fp32 cotangent rounded as it is loaded. 64 weight rows x 64 channels a
// CTA over 32-row chunks; eight warps, each 32 rows x 16 channels (2 x 2
// mma tiles). Both operands are stored transposed (m inner), so the row
// sum is the mma's K.
__global__ void __launch_bounds__(THREADS) conv_wgrad_bf16_kernel(
    const bf16* __restrict__ src, const float* __restrict__ dy,
    float* __restrict__ part, ConvGeom g, int m_per) {
  __shared__ __align__(16) bf16 At[WK][HLD];  // [k][m]
  __shared__ __align__(16) bf16 Dt[WN][HLD];  // [c][m]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wk = (warp % 2) * 32, wc = (warp / 2) * 16;
  const int M = g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int k0 = blockIdx.x * WK, c0 = blockIdx.y * WN;
  const int mb = blockIdx.z * m_per;
  const int me = min(M, mb + m_per);
  const int lm = tid >> 3, lk = (tid & 7) * 8;
  const int hw = g.ho * g.wo;

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int m0 = mb; m0 < me; m0 += HWM) {
    const int m = m0 + lm;
    const bool ok = m < me;
    int n = 0, oh = 0, ow = 0;
    if (ok) {
      n = m / hw;
      const int r = m - n * hw;
      oh = r / g.wo;
      ow = r - oh * g.wo;
    }
    float v[8];
    load_a8<false>(src, g, ok, n, oh, ow, k0 + lk, K, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) At[lk + e][lm] = __float2bfloat16_rn(v[e]);
    load_row8(dy, m, me, c0 + lk, g.cout, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) Dt[lk + e][lm] = __float2bfloat16_rn(v[e]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HWM; kk += 16) {
      uint32_t af[2][4], bfr[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wk + i * 16 + gq;
        af[i][0] = ld32(&At[r][kk + 2 * tq]);
        af[i][1] = ld32(&At[r + 8][kk + 2 * tq]);
        af[i][2] = ld32(&At[r][kk + 2 * tq + 8]);
        af[i][3] = ld32(&At[r + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wc + j * 8 + gq;
        bfr[j][0] = ld32(&Dt[c][kk + 2 * tq]);
        bfr[j][1] = ld32(&Dt[c][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + wk + i * 16 + gq + (e >= 2 ? 8 : 0);
        const int c = c0 + wc + j * 8 + 2 * tq + (e & 1);
        if (k < K && c < g.cout)
          part[((size_t)blockIdx.z * K + k) * g.cout + c] = acc[i][j][e];
      }
}

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

// Batch moments from conv_gemm_kernel's tile partials (tile t holds
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

// The stem's last pass: out = relu(y * sc + sh), in fp32, stored as OutT;
// out may alias y (fp32 instance).
template <typename OutT>
__global__ void bn_apply_kernel(const float* y, const float* __restrict__ sc,
                                const float* __restrict__ sh, OutT* out, long long total, int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    out[i] = from_f<OutT>(fmaxf(fmaf(y[i], sc[c], sh[c]), 0.f));
  }
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

ConvGeom geom(int n, int hi, int wi, int cin, int ho, int wo, int cout, int ks,
              int stride, int pad) {
  ConvGeom g;
  g.n = n; g.hi = hi; g.wi = wi; g.cin = cin;
  g.ho = ho; g.wo = wo; g.cout = cout;
  g.ks = ks; g.stride = stride; g.pad = pad;
  return g;
}

inline int conv_tiles(const ConvGeom& g) { return cdiv((long long)g.n * g.ho * g.wo, BM); }

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

// The fp32 convolution (fp32 weights): conv_gemm_kernel.
cudaError_t conv(bool trans, const float* src, const float* wt, float* out, BnScratch* stats,
                 const ConvGeom& g, cudaStream_t st) {
  const dim3 grid(conv_tiles(g), cdiv(g.cout, BN));
  float* pm = stats ? stats->pa : nullptr;
  float* pq = stats ? stats->pb : nullptr;
  if (trans)
    conv_gemm_kernel<true><<<grid, THREADS, 0, st>>>(src, wt, out, pm, pq, g);
  else
    conv_gemm_kernel<false><<<grid, THREADS, 0, st>>>(src, wt, out, pm, pq, g);
  return cudaGetLastError();
}

// The bf16 convolution (bf16 weights): conv_gemm_bf16_kernel, src bf16 or
// fp32, out fp32 (staged) or bf16 (an output).
template <typename SrcT, typename OutT>
cudaError_t conv(bool trans, const SrcT* src, const bf16* wt, OutT* out, BnScratch* stats,
                 const ConvGeom& g, cudaStream_t st) {
  const dim3 grid(conv_tiles(g), cdiv(g.cout, BN));
  float* pm = stats ? stats->pa : nullptr;
  float* pq = stats ? stats->pb : nullptr;
  if (trans)
    conv_gemm_bf16_kernel<true, SrcT, OutT><<<grid, THREADS, 0, st>>>(
        src, wt, out, pm, pq, g);
  else
    conv_gemm_bf16_kernel<false, SrcT, OutT><<<grid, THREADS, 0, st>>>(
        src, wt, out, pm, pq, g);
  return cudaGetLastError();
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

template <typename OutT>
cudaError_t apply(const float* y, const float* sc, const float* sh, OutT* out, long long rows,
                  int C, cudaStream_t st) {
  const long long total = rows * C;
  bn_apply_kernel<OutT><<<elementwise_grid(total), THREADS, 0, st>>>(y, sc, sh, out, total, C);
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

// Rows of the weight-gradient GEMM per split: enough splits to fill about
// WAVES CTAs, each split a whole number of wm-row chunks (WM under fp32
// compute, HWM under bf16).
int wgrad_rows_per_split(const ConvGeom& g, int wm) {
  const long long M = (long long)g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int ctas = cdiv(K, WK) * cdiv(g.cout, WN);
  const int chunks = cdiv(M, wm);
  int splits = cdiv(WAVES, ctas);
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  return cdiv(chunks, splits) * wm;
}

template <typename T>
constexpr int wgrad_chunk() {
  return std::is_same<T, float>::value ? WM : HWM;
}

template <typename T>
size_t wgrad_scratch(const ConvGeom& g) {
  const long long M = (long long)g.n * g.ho * g.wo;
  return (size_t)cdiv(M, wgrad_rows_per_split(g, wgrad_chunk<T>())) * g.ks * g.ks *
         g.cin * g.cout;
}

// The fp32 weight gradient: conv_wgrad_kernel, then the fp64 combine.
cudaError_t wgrad(const float* src, const float* dy, float* part, float* dw, const ConvGeom& g,
                  cudaStream_t st) {
  const long long M = (long long)g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int m_per = wgrad_rows_per_split(g, WM);
  const int splits = cdiv(M, m_per);
  conv_wgrad_kernel<<<dim3(cdiv(K, WK), cdiv(g.cout, WN), splits), THREADS, 0,
                      st>>>(src, dy, part, g, m_per);
  CHECK(cudaGetLastError());
  const long long count = (long long)K * g.cout;
  split_reduce_kernel<float><<<elementwise_grid(count), THREADS, 0, st>>>(
      part, splits, count, dw);
  return cudaGetLastError();
}

// The bf16 weight gradient (bf16 dw): conv_wgrad_bf16_kernel, then the
// same combine, rounded once to bf16.
cudaError_t wgrad(const bf16* src, const float* dy, float* part, bf16* dw, const ConvGeom& g,
                  cudaStream_t st) {
  const long long M = (long long)g.n * g.ho * g.wo;
  const int K = g.ks * g.ks * g.cin;
  const int m_per = wgrad_rows_per_split(g, HWM);
  const int splits = cdiv(M, m_per);
  conv_wgrad_bf16_kernel<<<dim3(cdiv(K, WK), cdiv(g.cout, WN), splits), THREADS, 0, st>>>(
      src, dy, part, g, m_per);
  CHECK(cudaGetLastError());
  const long long count = (long long)K * g.cout;
  split_reduce_kernel<bf16><<<elementwise_grid(count), THREADS, 0, st>>>(
      part, splits, count, dw);
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
  const ConvGeom g = geom(a->n, a->h, a->w, a->cin, a->h, a->w, a->cout, 3, 1, 1);
  const int rows = a->n * a->h * a->w;
  Arena ar{static_cast<char*>(ws)};
  BnScratch s = bn_scratch(ar, rows, a->cout);
  float* y = staged(ar, a->out, (size_t)rows * a->cout);
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  CHECK(conv(false, a->x, a->k, y, &s, g, st));
  CHECK(finalize(s, rows, a->cout, a->gamma, a->beta, a->eps, a->mean, a->var, st));
  return static_cast<int>(apply(y, s.scale, s.shift, a->out, rows, a->cout, st));
}

template <typename T>
static int stem_bwd_impl(const StemArgs<T>* a, void* ws, size_t* ws_bytes, cudaStream_t st) {
  const ConvGeom g = geom(a->n, a->h, a->w, a->cin, a->h, a->w, a->cout, 3, 1, 1);
  const int rows = a->n * a->h * a->w;
  Arena ar{static_cast<char*>(ws)};
  BnScratch s = bn_scratch(ar, rows, a->cout);
  float* y = ar.take((size_t)rows * a->cout);
  float* dp = ar.take((size_t)rows * a->cout);
  float* part = ar.take(wgrad_scratch<T>(g));
  if (!ws) {
    *ws_bytes = ar.off;
    return 0;
  }
  CHECK(fold_saved(s, a->mean, a->var, a->gamma, a->beta, a->eps, a->cout, st));
  CHECK(conv(false, a->x, a->k, y, nullptr, g, st));
  CHECK(bwd_sums(a->gout, nullptr, y, a->mean, s, a->gamma, a->beta, dp,
                              a->dbeta, a->dgamma, rows, a->cout, st));
  CHECK(bwd_apply(dp, y, a->mean, s, a->gamma, a->dbeta, a->dgamma, dp,
                               rows, a->cout, st));
  CHECK(wgrad(a->x, dp, part, a->dk, g, st));
  if (a->dx) {
    // transposed gather over dy [n, h, w, cout] with kt [3, 3, cout, cin]
    const ConvGeom gt = geom(a->n, a->h, a->w, a->cout, a->h, a->w, a->cin, 3, 1, 1);
    CHECK(conv(true, dp, a->kt, a->dx, nullptr, gt, st));
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
