// Fused NT-Xent / SupCon contrastive loss: forward and backward kernels for
// Hopper (sm_90a), with a plain C interface bound through ctypes
// (ops/native.py builds this file, ops/fused_loss.py wraps it).
//
// What each kernel replaces
//   supcon_fwd_kernel  <- simclr_pytorch_distributed_tpu/ops/pallas_loss.py
//                         _fwd_kernel :69 (reached through _fwd_call)
//   supcon_bwd_kernel  <- simclr_pytorch_distributed_tpu/ops/pallas_loss.py
//                         _bwd_kernel :114 (reached through _bwd_call)
//
// Both take the rectangular form of the Pallas calls: anchor rows
// frow [nr, D] against contrast columns fcol [nc, D], with per-row and
// per-column sample ids (idr, idc: positives share an id) and global ids
// (grow, gcol: a pair with equal global ids is the self-pair and is
// masked). The single-device loss passes frow == fcol and gid = arange(N);
// a sharded caller passes its local rows (a row slice of a larger tensor),
// the gathered columns and a rank offset in grow. Any nr >= 1, nc >= 2 and
// any D are taken: every tile masks its ragged edge, there is no
// divisibility gate.
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
// non-tensor fp32 that is ~1 us and ~2 us, and the bytes take under 0.1 us
// at 3.35 TB/s. So on paper they are compute bound; at this N they are
// bound by the launch and by the latency of one tile's loads, arithmetic
// and one combine, which only parallelism shortens. A grid of one CTA per
// 32-row tile gives 16 CTAs on 132 SMs. So the column walk of each row
// tile is split over a cluster of S = 8 CTAs (grid S x ceil(nr / 32): 128
// CTAs at N = 512), each walking ceil(tiles / S) column tiles of 64 with
// its per-row partials in registers, and the splits meet in distributed
// shared memory: each split pushes its partials to the CTA of the cluster
// that owns those rows (forward) or dF columns (backward), and after one
// cluster barrier each CTA combines what it owns from its own shared
// memory, splits in rank order. The result is bitwise repeatable, with no
// atomics, no second launch and no workspace in device memory; a dedicated
// inbox (not the ring) takes the pushes, so a split may push while its
// owner still walks, and no CTA reads another's shared memory after the
// barrier, so none waits for the others to leave. At N = 8192 (ImageNet
// SimCLR's global batch of 4096) the forward is 17 GFLOP, ~0.26 ms at the
// fp32 peak; the grid is 8 x 256 = 2048 CTAs of 16 column tiles each.
//
// Design. Arithmetic is fp32 FMA on CUDA cores: no TF32 and no tensor
// cores, so the kernels keep the 1e-5 agreement the port pins for its
// fused loss. A CTA owns BM = 32 anchor rows and has 256 threads in two
// depth groups of 128 (an 8 x 16 grid each): for every 32 x 64 logits tile
// each thread holds a 4 x 4 micro-tile (rows ty + 8 i, columns tx + 16 j)
// over its group's half of the feature depth, read from shared memory as
// float4 along the depth. The groups then add their halves through shared
// memory, each group finishing the 16 rows it owns (the same two floats
// added whichever group owns the row, so the order is fixed). The row tile
// is staged once for the whole walk; column tiles, with their ids, global
// ids and (backward) lse and cnt, come through a two-stage cp.async ring
// (16-byte copies when D % 4 == 0 and both feature pointers are 16-byte
// aligned, 4-byte copies otherwise, zero-filled past the matrices), so the
// loads of tile t + 1 overlap the FMAs of tile t, and no per-column word
// is held in registers across the FMAs: both kernels fit two CTAs an SM
// (at most 128 registers a thread) without spilling. Rows
// are staged at the full depth when D <= 128 (rounded up to 4, plus 4
// floats of padding so the lanes of a warp read distinct banks); wider D
// is walked in 128-deep chunks, each ring stage then carrying the rows'
// chunk beside the columns'. The Pallas kernel carried its running max /
// sum between sequential grid steps in VMEM scratch; here the walk is a
// loop inside the CTA and the running state lives in registers, reduced
// across the 16 lanes that share a row with warp shuffles. A split with no
// live column (past nc, or holding only the row's self column) keeps
// m = NEG and s = 0 and so adds exactly nothing to the combine.
//
// The backward recomputes each logits tile once over the full D, forms
// h_ij in shared memory and multiplies it by the column tile that is still
// staged, accumulating a partial dF of its rows over its columns in
// registers (a 32 x 128 slab, 4 x 4 a thread: the depth groups take its
// two 64-column halves). For D > 128 the grid gains a dimension of
// 128-wide dF slabs: each slab's CTAs recompute the logits over every
// chunk of D and restage their slab's chunk of the column tile for the
// product (the logits are recomputed once per slab; D <= 128, the recipe's
// feat_dim, is one slab). Rank r of the cluster owns 16 of the slab's 128
// columns: it sums the S partials of them, ranks in order, scales by
// coeff / tau and writes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 32;         // anchor rows per CTA
constexpr int BN = 64;         // contrast columns per tile
constexpr int S = 8;           // column splits: the CTAs of one cluster
constexpr int KMAX = 128;      // feature depth staged per chunk
constexpr int STAGES = 2;      // cp.async ring of column tiles
constexpr int GROUP = 128;     // threads of a depth group: an 8 x 16 grid
constexpr int GROUPS = 2;      // depth groups, each half of every chunk
constexpr int THREADS = GROUPS * GROUP;
constexpr int TR = BM / 8;     // rows per thread:    ty + 8 i
constexpr int TC = BN / 16;    // columns per thread: tx + 16 j
constexpr int OWN = TR / GROUPS;  // rows whose totals a thread owns: i = OWN kg + o
constexpr int DS = KMAX;       // backward: dF columns of one slab
constexpr int SL = DS / S;     // backward: dF columns each rank combines
constexpr int LDX = BN + 4;    // row stride of the logits exchange and of h
constexpr float NEG = -1e30f;  // the Pallas kernel's masked-logit value

static_assert(BM % S == 0 && DS % S == 0, "each rank combines an equal slice");
static_assert(BM == 4 * 8 && BN == 4 * 16 && DS == 2 * 64, "the two 8 x 16 thread grids");
static_assert(SL % 4 == 0, "the backward pushes float4s");
static_assert(GROUPS == 2, "the logits exchange pairs two depth groups");

// Sizes of one call, the same for both kernels.
struct Geom {
  int nr, nc, d;
  int d4;     // D rounded up to 4: the depth the inner loop reads
  int dk;     // staged depth of one chunk, min(d4, KMAX)
  int ldk;    // row stride of a staged tile in floats, dk + 4
  int nk;     // chunks over D
  int tiles;  // column tiles, ceil(nc / BN)
  int tps;    // column tiles per split, ceil(tiles / S)
};

Geom make_geom(int nr, int nc, int d) {
  Geom g;
  g.nr = nr;
  g.nc = nc;
  g.d = d;
  g.d4 = (d + 3) / 4 * 4;
  g.dk = g.d4 < KMAX ? g.d4 : KMAX;
  g.ldk = g.dk + 4;
  g.nk = (g.d4 + g.dk - 1) / g.dk;
  g.tiles = (nc + BN - 1) / BN;
  g.tps = (g.tiles + S - 1) / S;
  return g;
}

// Floats of the ring: the row tile (one slot when D is one chunk, a slot
// per stage otherwise) and STAGES column tiles.
size_t ring_floats(const Geom& g) {
  return static_cast<size_t>((g.nk == 1 ? 1 : STAGES) * BM + STAGES * BN) * g.ldk;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies of 16 or 4 bytes; an invalid one reads nothing and zero-fills.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier split in two: every thread arrives when its CTA
// starts and waits before its first access to another CTA's shared memory,
// which then has started too.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Stages rows [g0, g0 + rows) x depth [k0, k0 + dk) of src [n, d] into
// dst [rows][ldk]; rows past n and depth past d read as zero. Each thread
// walks its elements with an incremental (row, depth) pair.
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int rows,
                                      int g0, int n, int k0, const Geom& g) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  const int per_row = g.dk / W, total = rows * per_row;
  const int dr = THREADS / per_row, dc = THREADS - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int gr = g0 + r, gk = k0 + c * W;
    const bool ok = gr < n && gk < g.d;
    const float* from = ok ? src + (size_t)gr * g.d + gk : src;
    if (VEC)
      cp_async16(dst + r * g.ldk + c * W, from, ok);
    else
      cp_async4(dst + r * g.ldk + c * W, from, ok);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Stages the per-column words of columns [col0, col0 + BN) into
// dst [4][BN], one copy a thread: ids, global ids and, for the backward
// (src2, src3 not null), lse and cnt; columns past nc read as zero.
__device__ __forceinline__ void stage_meta(uint32_t* dst, const void* src0, const void* src1,
                                           const void* src2, const void* src3, int col0,
                                           int nc) {
  static_assert(THREADS == 4 * BN, "one column word a thread for four arrays");
  const int a = threadIdx.x / BN, c = threadIdx.x % BN;
  const void* src = a == 0 ? src0 : a == 1 ? src1 : a == 2 ? src2 : src3;
  if (src != nullptr) {
    const bool ok = col0 + c < nc;
    cp_async4(dst + a * BN + c, static_cast<const uint32_t*>(src) + (ok ? col0 + c : 0), ok);
  }
}

// acc[i][j] += <rows[ty + 8 i][k0, k1), cols[tx + 16 j][k0, k1)>, in depth
// order, four depths a shared-memory read.
__device__ __forceinline__ void logits_part(const float* rows, const float* cols, int ldk,
                                            int k0, int k1, int ty, int tx,
                                            float (&acc)[TR][TC]) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float4 a[TR], b[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      a[i] = *reinterpret_cast<const float4*>(rows + (ty + 8 * i) * ldk + k);
#pragma unroll
    for (int j = 0; j < TC; ++j)
      b[j] = *reinterpret_cast<const float4*>(cols + (tx + 16 * j) * ldk + k);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// Depth group kg of a chunk kw deep (a multiple of 4) takes depths
// [depth_bound(kw, kg), depth_bound(kw, kg + 1)).
__device__ __forceinline__ int depth_bound(int kw, int kg) { return kw / 4 * kg / GROUPS * 4; }

// The two depth groups' partial logits meet: group kg hands over the rows
// it does not own and adds the other group's partial of the rows it owns,
// giving lt[o][j] = logit of row ty + 8 (OWN kg + o), column tx + 16 j,
// times inv_temp. Both groups add the same two floats, so the sum does not
// depend on which group owns the row.
__device__ __forceinline__ void exchange(float* x, const float (&acc)[TR][TC], int kg, int ty,
                                         int tx, float inv_temp, float (&lt)[OWN][TC]) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
    if (i / OWN != kg)
#pragma unroll
      for (int j = 0; j < TC; ++j) x[(ty + 8 * i) * LDX + tx + 16 * j] = acc[i][j];
  __syncthreads();
#pragma unroll
  for (int o = 0; o < OWN; ++o)
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float mine = kg ? acc[OWN + o][j] : acc[o][j];  // no runtime register index
      lt[o][j] = (mine + x[(ty + 8 * (OWN * kg + o)) * LDX + tx + 16 * j]) * inv_temp;
    }
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

template <bool VEC>
__global__ void __cluster_dims__(S, 1, 1) __launch_bounds__(THREADS, 2) supcon_fwd_kernel(
    const float* __restrict__ frow, const float* __restrict__ fcol,
    const int* __restrict__ idr, const int* __restrict__ idc,
    const int* __restrict__ grow, const int* __restrict__ gcol,
    float* __restrict__ loss, float* __restrict__ lse, float* __restrict__ cnt,
    const Geom g, float inv_temp, float scale) {
  extern __shared__ float4 smem4[];
  // inbox[q][r]: split q's (m, s, p, c) of row split * BM / S + r
  __shared__ float4 inbox[S][BM / S];
  float* rows_s = reinterpret_cast<float*>(smem4);
  float* cols_s = rows_s + (g.nk == 1 ? 1 : STAGES) * BM * g.ldk;
  float* x_s = cols_s + STAGES * BN * g.ldk;
  // [STAGES][2][BN]: the staged columns' ids and global ids
  uint32_t* meta_s = reinterpret_cast<uint32_t*>(x_s + BM * LDX);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, kg = tid / GROUP, ty = tid % GROUP / 16, tx = tid % 16;
  const int row0 = blockIdx.y * BM;

  int rid[OWN], rg[OWN];
  float m[OWN], ssum[OWN], psum[OWN], pcnt[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int r = row0 + ty + 8 * (OWN * kg + o);
    rid[o] = r < g.nr ? idr[r] : 0;
    rg[o] = r < g.nr ? grow[r] : 0;
    m[o] = NEG;
    ssum[o] = psum[o] = pcnt[o] = 0.f;
  }

  // This split's column tiles [t0, t1), nk ring steps each.
  const int t0 = split * g.tps;
  const int t1 = min(t0 + g.tps, g.tiles);
  const int steps = t1 > t0 ? (t1 - t0) * g.nk : 0;
  auto issue = [&](int step) {
    const int st = step % STAGES, kc = step % g.nk, col0 = (t0 + step / g.nk) * BN;
    if (g.nk > 1) stage<VEC>(rows_s + st * BM * g.ldk, frow, BM, row0, g.nr, kc * g.dk, g);
    stage<VEC>(cols_s + st * BN * g.ldk, fcol, BN, col0, g.nc, kc * g.dk, g);
    stage_meta(meta_s + st * 2 * BN, idc, gcol, nullptr, nullptr, col0, g.nc);
  };
  if (steps > 0) {
    if (g.nk == 1) stage<VEC>(rows_s, frow, BM, row0, g.nr, 0, g);
    issue(0);
  }
  cp_async_commit();

  float acc[TR][TC];
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    cp_async_commit();
    const int st = step % STAGES, kc = step % g.nk, col0 = (t0 + step / g.nk) * BN;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    const int kw = min(g.dk, g.d4 - kc * g.dk);
    logits_part(rows_s + (g.nk == 1 ? 0 : st * BM * g.ldk), cols_s + st * BN * g.ldk, g.ldk,
                depth_bound(kw, kg), depth_bound(kw, kg + 1), ty, tx, acc);
    if (kc == g.nk - 1) {
      float lt[OWN][TC];
      exchange(x_s, acc, kg, ty, tx, inv_temp, lt);
      const uint32_t* meta = meta_s + st * 2 * BN;
      bool cv[TC];
      int cid[TC], cgid[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        cv[j] = col0 + tx + 16 * j < g.nc;
        cid[j] = static_cast<int>(meta[tx + 16 * j]);
        cgid[j] = static_cast<int>(meta[BN + tx + 16 * j]);
      }
#pragma unroll
      for (int o = 0; o < OWN; ++o) {
        bool live[TC];  // a real column that is not this row's self-pair
        float bmax = NEG;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          live[j] = cv[j] && cgid[j] != rg[o];
          if (live[j]) bmax = fmaxf(bmax, lt[o][j]);
        }
        const float nm = fmaxf(m[o], row_max(bmax));
        float bs = 0.f, bp = 0.f, bc = 0.f;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          if (!live[j]) continue;
          bs += expf(lt[o][j] - nm);
          if (cid[j] == rid[o]) {
            bp += lt[o][j];
            bc += 1.f;
          }
        }
        ssum[o] = ssum[o] * expf(m[o] - nm) + row_sum(bs);
        m[o] = nm;
        psum[o] += row_sum(bp);
        pcnt[o] += row_sum(bc);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // Each split pushes its partials of row lr into the inbox of rank
  // lr / (BM / S); after the barrier every rank combines its rows from its
  // own shared memory, splits in rank order, and no shared memory is read
  // remotely, so a CTA may leave as soon as it is done.
  cluster_wait();
  if (tx == 0) {
#pragma unroll
    for (int o = 0; o < OWN; ++o) {
      const int lr = ty + 8 * (OWN * kg + o);
      *cluster.map_shared_rank(&inbox[split][lr % (BM / S)], lr / (BM / S)) =
          make_float4(m[o], ssum[o], psum[o], pcnt[o]);
    }
  }
  cluster.sync();
  if (tid < BM / S) {
    const int r = row0 + split * (BM / S) + tid;
    float mx = NEG;
#pragma unroll
    for (int q = 0; q < S; ++q) mx = fmaxf(mx, inbox[q][tid].x);
    float s = 0.f, p = 0.f, c = 0.f;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const float4 v = inbox[q][tid];
      s += v.y * expf(v.x - mx);
      p += v.z;
      c += v.w;
    }
    if (r < g.nr) {
      const float row_lse = mx + logf(s);
      lse[r] = row_lse;
      cnt[r] = c;
      loss[r] = -scale * (p / c - row_lse);
    }
  }
}

template <bool VEC>
__global__ void __cluster_dims__(S, 1, 1) __launch_bounds__(THREADS, 2) supcon_bwd_kernel(
    const float* __restrict__ frow, const float* __restrict__ fcol,
    const int* __restrict__ idr, const int* __restrict__ idc,
    const int* __restrict__ grow, const int* __restrict__ gcol,
    const float* __restrict__ lse_r, const float* __restrict__ lse_c,
    const float* __restrict__ cnt_r, const float* __restrict__ cnt_c,
    float* __restrict__ dfeat, const Geom g, float inv_temp, float coeff) {
  extern __shared__ float4 smem4[];
  float* rows_s = reinterpret_cast<float*>(smem4);
  float* cols_s = rows_s + (g.nk == 1 ? 1 : STAGES) * BM * g.ldk;
  float* x_s = cols_s + STAGES * BN * g.ldk;  // [BM][LDX]: the exchange, then h
  float* inbox = x_s + BM * LDX;  // [S][BM][SL]: split q's partial dF of this rank's slice
  // [STAGES][4][BN]: the staged columns' ids, global ids, lse and cnt
  uint32_t* meta_s = reinterpret_cast<uint32_t*>(inbox + S * BM * SL);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, kg = tid / GROUP, ty = tid % GROUP / 16, tx = tid % 16;
  const int row0 = blockIdx.y * BM, slab = blockIdx.z;
  // this thread's dF columns in the slab, 4 dd .. 4 dd + 3, and the depth
  // of the slab's staged chunk that lies inside D
  const int dd = 4 * tx + 64 * kg;
  const int kw_slab = min(g.dk, g.d4 - slab * g.dk);

  int rid[OWN], rg[OWN];
  float rl[OWN], rc[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int r = row0 + ty + 8 * (OWN * kg + o);
    const bool rv = r < g.nr;
    rid[o] = rv ? idr[r] : 0;
    rg[o] = rv ? grow[r] : 0;
    rl[o] = rv ? lse_r[r] : 0.f;
    rc[o] = rv ? cnt_r[r] : 1.f;
  }
  float acc[TR][4];  // dF[row0 + ty + 8 i][slab * dk + dd + e]
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // Ring steps per column tile: the nk chunks of the logits, then, when D
  // is more than one chunk, the slab's chunk of the columns again.
  const int per_tile = g.nk == 1 ? 1 : g.nk + 1;
  const int t0 = split * g.tps;
  const int t1 = min(t0 + g.tps, g.tiles);
  const int steps = t1 > t0 ? (t1 - t0) * per_tile : 0;
  auto issue = [&](int step) {
    const int st = step % STAGES, ph = step % per_tile, col0 = (t0 + step / per_tile) * BN;
    if (ph < g.nk && g.nk > 1)
      stage<VEC>(rows_s + st * BM * g.ldk, frow, BM, row0, g.nr, ph * g.dk, g);
    stage<VEC>(cols_s + st * BN * g.ldk, fcol, BN, col0, g.nc,
               (ph < g.nk ? ph : slab) * g.dk, g);
    stage_meta(meta_s + st * 4 * BN, idc, gcol, lse_c, cnt_c, col0, g.nc);
  };
  if (steps > 0) {
    if (g.nk == 1) stage<VEC>(rows_s, frow, BM, row0, g.nr, 0, g);
    issue(0);
  }
  cp_async_commit();

  float lacc[TR][TC];
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    cp_async_commit();
    const int st = step % STAGES, ph = step % per_tile, col0 = (t0 + step / per_tile) * BN;
    const float* cols = cols_s + st * BN * g.ldk;
    if (ph == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) lacc[i][j] = 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    if (ph < g.nk) {
      const int kw = min(g.dk, g.d4 - ph * g.dk);
      logits_part(rows_s + (g.nk == 1 ? 0 : st * BM * g.ldk), cols, g.ldk, depth_bound(kw, kg),
                  depth_bound(kw, kg + 1), ty, tx, lacc);
    }
    if (ph == g.nk - 1) {
      float lt[OWN][TC];
      exchange(x_s, lacc, kg, ty, tx, inv_temp, lt);
      const uint32_t* meta = meta_s + st * 4 * BN;
      bool cv[TC];
      int cid[TC], cgid[TC];
      float cl[TC], cc[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = tx + 16 * j;
        cv[j] = col0 + c < g.nc;
        cid[j] = static_cast<int>(meta[c]);
        cgid[j] = static_cast<int>(meta[BN + c]);
        cl[j] = __uint_as_float(meta[2 * BN + c]);
        cc[j] = __uint_as_float(meta[3 * BN + c]);
      }
      __syncthreads();  // the exchange is read: its buffer takes h
#pragma unroll
      for (int o = 0; o < OWN; ++o)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float h = 0.f;
          if (cv[j]) {
            const bool self = cgid[j] == rg[o];
            const float pos = (!self && cid[j] == rid[o]) ? 1.f : 0.f;
            const float smi = self ? 0.f : expf(lt[o][j] - rl[o]);
            const float smj = self ? 0.f : expf(lt[o][j] - cl[j]);
            h = (smi - pos / rc[o]) + (smj - pos / cc[j]);
          }
          x_s[(ty + 8 * (OWN * kg + o)) * LDX + tx + 16 * j] = h;
        }
      __syncthreads();
    }
    if (ph == (g.nk == 1 ? 0 : g.nk) && dd < kw_slab) {  // the slab's chunk is staged
#pragma unroll 2
      for (int c = 0; c < BN; c += 4) {
        float4 hv[TR], fv[4];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          hv[i] = *reinterpret_cast<const float4*>(x_s + (ty + 8 * i) * LDX + c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fv[e] = *reinterpret_cast<const float4*>(cols + (c + e) * g.ldk + dd);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float hh[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][0] = fmaf(hh[e], fv[e].x, acc[i][0]);
            acc[i][1] = fmaf(hh[e], fv[e].y, acc[i][1]);
            acc[i][2] = fmaf(hh[e], fv[e].z, acc[i][2]);
            acc[i][3] = fmaf(hh[e], fv[e].w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // Each split pushes its partial dF columns into the inbox of the rank
  // that owns them (SL columns a rank); after the barrier every rank sums
  // its slice from its own shared memory, splits in rank order.
  cluster_wait();
  {
    float4* to = cluster.map_shared_rank(reinterpret_cast<float4*>(inbox), dd / SL);
#pragma unroll
    for (int i = 0; i < TR; ++i)
      to[((split * BM + ty + 8 * i) * SL + dd % SL) / 4] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster.sync();
  const float out_scale = coeff * inv_temp;
  if (tid < BM * SL / 4) {
    const int lr = tid / (SL / 4), lc = tid % (SL / 4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const float4 w = reinterpret_cast<const float4*>(inbox)[((q * BM + lr) * SL + lc) / 4];
      v[0] += w.x;
      v[1] += w.y;
      v[2] += w.z;
      v[3] += w.w;
    }
    const int r = row0 + lr, d0 = slab * g.dk + split * SL + lc;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r < g.nr && d0 + e < g.d) dfeat[(size_t)r * g.d + d0 + e] = v[e] * out_scale;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename K, typename... A>
int launch(K kernel, dim3 grid, size_t smem, void* stream, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream, does not synchronise,
// and returns a cudaError_t so a refused launch reaches the caller.

int supcon_fwd(const float* frow, const float* fcol, const int* idr,
               const int* idc, const int* grow, const int* gcol, float* loss,
               float* lse, float* cnt, int nr, int nc, int d, float inv_temp,
               float scale, void* stream) {
  const Geom g = make_geom(nr, nc, d);
  const dim3 grid(S, (nr + BM - 1) / BM);
  const size_t smem = (ring_floats(g) + BM * LDX + STAGES * 2 * BN) * sizeof(float);
  const bool vec = d % 4 == 0 && aligned16(frow) && aligned16(fcol);
  return launch(vec ? &supcon_fwd_kernel<true> : &supcon_fwd_kernel<false>, grid, smem, stream,
                frow, fcol, idr, idc, grow, gcol, loss, lse, cnt, g, inv_temp, scale);
}

int supcon_bwd(const float* frow, const float* fcol, const int* idr,
               const int* idc, const int* grow, const int* gcol,
               const float* lse_r, const float* lse_c, const float* cnt_r,
               const float* cnt_c, float* dfeat, int nr, int nc, int d,
               float inv_temp, float coeff, void* stream) {
  const Geom g = make_geom(nr, nc, d);
  const dim3 grid(S, (nr + BM - 1) / BM, g.nk);
  const size_t smem =
      (ring_floats(g) + BM * LDX + S * BM * SL + STAGES * 4 * BN) * sizeof(float);
  const bool vec = d % 4 == 0 && aligned16(frow) && aligned16(fcol);
  return launch(vec ? &supcon_bwd_kernel<true> : &supcon_bwd_kernel<false>, grid, smem, stream,
                frow, fcol, idr, idc, grow, gcol, lse_r, lse_c, cnt_r, cnt_c, dfeat, g,
                inv_temp, coeff);
}

}  // extern "C"
