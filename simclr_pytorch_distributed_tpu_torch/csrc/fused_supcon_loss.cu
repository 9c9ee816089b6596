// Fused NT-Xent / SupCon contrastive loss: forward and backward kernels for
// Hopper (sm_90a), with a plain C interface bound through ctypes
// (ops/native.py builds this file, ops/fused_loss.py wraps it).
//
// What each kernel replaces
//   supcon_fwd_kernel  <- simclr_pytorch_distributed_tpu/ops/pallas_loss.py
//                         _fwd_kernel (reached through _fwd_call)
//   supcon_bwd_kernel  <- simclr_pytorch_distributed_tpu/ops/pallas_loss.py
//                         _bwd_kernel (reached through _bwd_call)
//
// Both take the rectangular form of the Pallas calls: anchor rows
// frow [nr, D] against contrast columns fcol [nc, D], with per-row and
// per-column sample ids (idr, idc: positives share an id) and global ids
// (grow, gcol: a pair with equal global ids is the self-pair and is
// masked). The single-device loss passes frow == fcol and gid = arange(N);
// a sharded caller passes its local rows, the gathered columns and a rank
// offset in grow. Any nr, nc >= 1 and any D are taken: every tile masks its
// ragged edge, there is no divisibility gate.
//
// Forward, per anchor row i (logits l_ij = <f_i, f_j> / tau, self masked):
//   lse_i  = log sum_{j != i} exp(l_ij)            (online max + sum-exp)
//   cnt_i  = #{j != i : id_j == id_i}
//   loss_i = -(tau / tau_base) * (sum_{pos} l_ij / cnt_i - lse_i)
// The mean over rows and the cotangent scale stay in the caller.
//
// Backward, per anchor row i (coeff = (tau / tau_base) / N):
//   dF_i = coeff / tau * sum_j [(sm_ij - P_ij/cnt_i) + (sm_ji - P_ij/cnt_j)] F_j
// with sm_ij = exp(l_ij - lse_i) <= 1 (lse_i bounds the row max, so the
// recomputed exponentials cannot overflow). Each logits tile is recomputed;
// nothing of size N x N is ever stored.
//
// What bounds them. At the recipe shape (N = 512, D = 128, fp32) the
// forward does 2 N^2 D = 67 MFLOP and reads 256 KB of features; the
// backward does twice the FLOPs. Against the H100's ~67 TFLOP/s of
// non-tensor fp32 that is ~1 us and ~2 us, and the bytes take well under
// that at 3.35 TB/s, so on paper both are compute bound; in practice at
// this N both are bound by launch latency and by how few CTAs there are
// (N / 32 row tiles). They pay off at large global batch, where the dense
// path's [N, N] temporaries grow quadratically while these kernels keep
// every logits tile in registers and shared memory.
//
// Design. Arithmetic is fp32 FMA on CUDA cores: no TF32 and no tensor
// cores, so the kernels keep the 1e-5 agreement the JAX package pins for
// its fused loss. A CTA of 256 threads owns BM = 32 anchor rows and walks
// the columns in tiles of BN = 64; features are staged through shared
// memory in DK = 32 deep chunks, and each thread holds a 2 x 4 micro-tile
// of logits in registers. The Pallas kernel carried its running max / sum
// between sequential grid steps in VMEM scratch; here the column walk is a
// loop inside the CTA and the per-row running state lives in registers,
// reduced across the 16 lanes that share a row with warp shuffles. The
// backward adds a y grid dimension over D in chunks of DC = 64 (more CTAs
// in flight, at the price of recomputing the logits once per chunk) and
// accumulates its dF tile in registers; the softmax weights of each tile
// pass through shared memory to meet the staged feature columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 32;         // anchor rows per CTA
constexpr int BN = 64;         // contrast columns per tile
constexpr int DK = 32;         // feature depth staged per chunk
constexpr int DC = 64;         // backward: dF columns per CTA
constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int TR = BM / 16;    // rows per thread:    ty + 16 i
constexpr int TC = BN / 16;    // columns per thread: tx + 16 j
constexpr float NEG = -1e30f;  // the Pallas kernel's masked-logit value

static_assert(DC == BN, "the backward reuses the forward's thread layout");

struct TileSmem {
  float a[DK][BM + 1];  // frow chunk, transposed; +1 avoids bank conflicts
  float b[DK][BN + 1];  // fcol chunk, transposed
};

// l[i][j] = <frow[row0 + ty + 16 i], fcol[col0 + tx + 16 j]> * inv_temp.
// Rows or columns past the matrices read as zero features.
__device__ __forceinline__ void logits_tile(
    const float* __restrict__ frow, const float* __restrict__ fcol,
    int nr, int nc, int d, int row0, int col0, float inv_temp,
    TileSmem& s, float (&l)[TR][TC]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int r = e / DK, k = e % DK, gr = row0 + r, gk = k0 + k;
      s.a[k][r] = (gr < nr && gk < d) ? frow[(size_t)gr * d + gk] : 0.f;
    }
    for (int e = tid; e < BN * DK; e += THREADS) {
      const int c = e / DK, k = e % DK, gc = col0 + c, gk = k0 + k;
      s.b[k][c] = (gc < nc && gk < d) ? fcol[(size_t)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = s.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = s.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) l[i][j] = acc[i][j] * inv_temp;
}

// Reductions over the 16 lanes that hold one row (same ty, tx = 0..15).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

__global__ void __launch_bounds__(THREADS) supcon_fwd_kernel(
    const float* __restrict__ frow, const float* __restrict__ fcol,
    const int* __restrict__ idr, const int* __restrict__ idc,
    const int* __restrict__ grow, const int* __restrict__ gcol,
    float* __restrict__ loss, float* __restrict__ lse, float* __restrict__ cnt,
    int nr, int nc, int d, float inv_temp, float scale) {
  __shared__ TileSmem s;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM;

  int rid[TR], rg[TR];
  float m[TR], ssum[TR], psum[TR], pcnt[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + 16 * i;
    rid[i] = r < nr ? idr[r] : 0;
    rg[i] = r < nr ? grow[r] : 0;
    m[i] = NEG;
    ssum[i] = psum[i] = pcnt[i] = 0.f;
  }

  for (int col0 = 0; col0 < nc; col0 += BN) {
    float l[TR][TC];
    logits_tile(frow, fcol, nr, nc, d, row0, col0, inv_temp, s, l);
    bool cv[TC];
    int cid[TC], cg[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = col0 + tx + 16 * j;
      cv[j] = c < nc;
      cid[j] = cv[j] ? idc[c] : 0;
      cg[j] = cv[j] ? gcol[c] : 0;
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      bool live[TC];  // a real column that is not this row's self-pair
      float bmax = NEG;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        live[j] = cv[j] && cg[j] != rg[i];
        if (live[j]) bmax = fmaxf(bmax, l[i][j]);
      }
      const float nm = fmaxf(m[i], row_max(bmax));
      float bs = 0.f, bp = 0.f, bc = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        if (!live[j]) continue;
        bs += expf(l[i][j] - nm);
        if (cid[j] == rid[i]) {
          bp += l[i][j];
          bc += 1.f;
        }
      }
      ssum[i] = ssum[i] * expf(m[i] - nm) + row_sum(bs);
      m[i] = nm;
      psum[i] += row_sum(bp);
      pcnt[i] += row_sum(bc);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= nr) continue;
      const float row_lse = m[i] + logf(ssum[i]);
      lse[r] = row_lse;
      cnt[r] = pcnt[i];
      loss[r] = -scale * (psum[i] / pcnt[i] - row_lse);
    }
  }
}

struct BwdSmem {
  TileSmem t;
  float h[BM][BN + 1];  // the tile's softmax-minus-positive weights
  float f[BN][DC];      // fcol[col0 .. col0 + BN) x [d0 .. d0 + DC)
};

__global__ void __launch_bounds__(THREADS) supcon_bwd_kernel(
    const float* __restrict__ frow, const float* __restrict__ fcol,
    const int* __restrict__ idr, const int* __restrict__ idc,
    const int* __restrict__ grow, const int* __restrict__ gcol,
    const float* __restrict__ lse_r, const float* __restrict__ lse_c,
    const float* __restrict__ cnt_r, const float* __restrict__ cnt_c,
    float* __restrict__ dfeat, int nr, int nc, int d, float inv_temp,
    float coeff) {
  __shared__ BwdSmem s;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM, d0 = blockIdx.y * DC;

  int rid[TR], rg[TR];
  float rl[TR], rc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + 16 * i;
    const bool rv = r < nr;
    rid[i] = rv ? idr[r] : 0;
    rg[i] = rv ? grow[r] : 0;
    rl[i] = rv ? lse_r[r] : 0.f;
    rc[i] = rv ? cnt_r[r] : 1.f;
  }
  float acc[TR][TC];  // dF[row0 + ty + 16 i][d0 + tx + 16 j]
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  for (int col0 = 0; col0 < nc; col0 += BN) {
    float l[TR][TC];
    logits_tile(frow, fcol, nr, nc, d, row0, col0, inv_temp, s.t, l);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = col0 + tx + 16 * j;
      const bool cv = c < nc;
      const int cid = cv ? idc[c] : 0, cg = cv ? gcol[c] : 0;
      const float cl = cv ? lse_c[c] : 0.f, cc = cv ? cnt_c[c] : 1.f;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float h = 0.f;
        if (cv) {
          const bool self = cg == rg[i];
          const float pos = (!self && cid == rid[i]) ? 1.f : 0.f;
          const float smi = self ? 0.f : expf(l[i][j] - rl[i]);
          const float smj = self ? 0.f : expf(l[i][j] - cl);
          h = (smi - pos / rc[i]) + (smj - pos / cc);
        }
        s.h[ty + 16 * i][tx + 16 * j] = h;
      }
    }
    for (int e = tid; e < BN * DC; e += THREADS) {
      const int c = e / DC, dd = e % DC, gc = col0 + c, gd = d0 + dd;
      s.f[c][dd] = (gc < nc && gd < d) ? fcol[(size_t)gc * d + gd] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BN; ++c) {
      float hv[TR], fv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) hv[i] = s.h[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < TC; ++j) fv[j] = s.f[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(hv[i], fv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float out_scale = coeff * inv_temp;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int dd = d0 + tx + 16 * j;
      if (dd < d) dfeat[(size_t)r * d + dd] = acc[i][j] * out_scale;
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so a refused launch reaches the caller.

int supcon_fwd(const float* frow, const float* fcol, const int* idr,
               const int* idc, const int* grow, const int* gcol, float* loss,
               float* lse, float* cnt, int nr, int nc, int d, float inv_temp,
               float scale, void* stream) {
  const dim3 grid((nr + BM - 1) / BM);
  supcon_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frow, fcol, idr, idc, grow, gcol, loss, lse, cnt, nr, nc, d, inv_temp,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int supcon_bwd(const float* frow, const float* fcol, const int* idr,
               const int* idc, const int* grow, const int* gcol,
               const float* lse_r, const float* lse_c, const float* cnt_r,
               const float* cnt_c, float* dfeat, int nr, int nc, int d,
               float inv_temp, float coeff, void* stream) {
  const dim3 grid((nr + BM - 1) / BM, (d + DC - 1) / DC);
  supcon_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frow, fcol, idr, idc, grow, gcol, lse_r, lse_c, cnt_r, cnt_c, dfeat, nr,
      nc, d, inv_temp, coeff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
