// Pipelined implicit-GEMM convolution and weight-gradient kernels for
// Hopper (sm_90a), one design per compute dtype, included by
// fused_conv_bn.cu. Every block entry point (fp32 and bf16) runs every
// convolution through them: bottleneck_fwd its four forward convs and
// basic_fwd and proj_fwd their two or three, with the statistics epilogue;
// bottleneck_bwd, basic_bwd and proj_bwd the recomputed forward convs, the
// data gradients and the weight gradients; stem_bwd its data gradient,
// when one is wanted.
//
// A convolution is a GEMM over an explicit list of taps. Each GEMM row is
// a pixel (b, i, j) of a row grid [n, gh, gw]; tap t reads the source
// pixel (i * ss + dh_t, j * ss + dw_t) (zero outside the source grid) and
// multiplies its channels by the weight rows wrow_t .. wrow_t + cs; the
// result lands at the output pixel (i * os + oph, j * os + opw). A forward
// conv is one class of ks * ks taps; the transposed 3x3/s2 of the data
// gradient is four classes, one per parity (ih mod 2, iw mod 2) of the
// input grid, each with only the 1, 2, 2 or 4 taps that reach it, so no
// zero of the dilated gradient is ever multiplied. K is walked tap-major,
// then in channel chunks; a chunk never straddles two taps (channels past
// cs are zero-filled), and each thread computes its rows' pixels once.
//
// Operands are plain tensors in the compute dtype, with no prologue, so
// every load is a 16-byte cp.async (zero-filled outside the image, past
// the channels or past the rows) into a ring of shared-memory stages; a
// scalar path serves channel counts that are no multiple of 16 bytes.
//   bf16: wgmma.mma_async m64nNk16 (N = 128, or 64 for narrow outputs),
//     fp32 accumulators in registers, two consumer warpgroups per
//     128-row tile. Operands sit in shared memory in the 128-byte
//     swizzled layout the wgmma descriptors take (1024-byte atoms of eight
//     128-byte lines, 16-byte chunks permuted by line, so the tensor
//     cores read them without bank conflicts): the im2col operand
//     K-major, the weights MN-major (the descriptor's transpose bit). The
//     weight gradient reduces over pixels, so both of its operands are
//     MN-major. A ring of three stages (96 KB at N = 128, so two CTAs
//     share an SM): loads for chunks k + 1 and k + 2 are in flight while
//     chunk k multiplies. Every thread both loads and multiplies, so the
//     ring is synchronised by cp.async groups and one barrier before and
//     one after each chunk's loads land, not by mbarriers. The output tile
//     leaves through shared memory in 16-byte stores.
//   fp32: FMA on the CUDA cores (the fp32 contract rules out TF32): a
//     128 x 128 (or 128 x 64) tile per CTA, each thread an 8 x 8 (or
//     8 x 4) register micro-tile fed by 16-byte shared loads (16 FMAs per
//     load), a ring of three cp.async stages.
// Epilogues: the fp32 result (+ a residual), stored fp32 or in the compute
// dtype, and optionally a second output a = rnd(relu(v * sc + sh)) in the
// compute dtype: the next conv's operand, rounded where the Pallas kernel
// rounds it (its _fill_pad cast). The statistics epilogue (one-class
// plans, fp32 out, no residual; a template flag, so the kernels without it
// compile as before) writes, per CTA and output channel, the mean of the
// fp32 result over the tile's valid rows and the sum of squares about that
// mean: part_mean / part_m2 [tiles, cout], tile t holding min(128, rows -
// 128 t) rows, which bn_finalize_kernel in fused_conv_bn.cu combines in
// fp64. bf16 reduces the fp32 tile that already sits in shared memory for
// the stores, fp32 each thread's micro-tile in registers and then the 16
// row lanes through shared memory (the ring is free after the main loop);
// both sum in a fixed order. The weight gradient writes fp32 partials per
// row split, which split_reduce_kernel combines in fp64 in a fixed order:
// no atomics, so every call is bitwise repeatable.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int MAX_TAPS = 9, MAX_CLASSES = 4;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_BM = 128;  // output rows (or weight rows) per CTA

struct Tap {
  int dh, dw, wrow;
};

// One class of output pixels: its taps, its output offsets, and whether
// it adds the residual.
struct ConvClass {
  int ntaps;
  Tap tap[MAX_TAPS];
  int oph, opw, residual;
};

struct ConvPlan {
  int n, hs, ws, cs;  // the source [n, hs, ws, cs]
  int gh, gw, ss;     // the row grid [n, gh, gw] of each class, source stride
  int oh, ow, os;     // the output grid [n, oh, ow, cout], output stride
  int cout;
  int nclass;
  ConvClass cls[MAX_CLASSES];
};

template <typename T>
struct Vec {
  static constexpr int N = 16 / (int)sizeof(T);  // elements per 16 bytes
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (no
// bytes are read then, but src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte group of V elements: from g (nvalid of them valid, the rest
// zero) into shared memory at dst. vec: the tensor's rows are whole
// 16-byte groups, so nvalid is 0 or V and one cp.async moves it; else the
// elements are copied one by one.
template <typename T>
__device__ __forceinline__ void load_group(T* dst, const T* g, int nvalid, bool vec,
                                           const T* any) {
  if (vec) {
    cp_async16(dst, nvalid > 0 ? g : any, nvalid > 0);
  } else {
#pragma unroll
    for (int e = 0; e < Vec<T>::N; ++e) dst[e] = e < nvalid ? g[e] : from_f<T>(0.f);
  }
}

__device__ __forceinline__ int clamp_valid(int left, int v) {
  return left <= 0 ? 0 : (left < v ? left : v);
}

// The source row pixel base of GEMM row r of a class: batch offset (in
// pixels) and (i * ss, j * ss); ok = r is a row of the grid.
struct RowBase {
  long long pix0;  // b * hs * ws
  int h, w;        // i * ss, j * ss
  bool ok;
};

__device__ __forceinline__ RowBase row_base(const ConvPlan& p, int r, int rows) {
  RowBase rb;
  rb.ok = r < rows;
  const int rr = rb.ok ? r : 0;
  const int hw = p.gh * p.gw;
  const int b = rr / hw;
  const int q = rr - b * hw;
  const int i = q / p.gw;
  rb.pix0 = (long long)b * p.hs * p.ws;
  rb.h = i * p.ss;
  rb.w = (q - i * p.gw) * p.ss;
  return rb;
}

// The element offset of the source pixel at tap (dh, dw), or -1 outside.
__device__ __forceinline__ long long src_offset(const ConvPlan& p, const RowBase& rb, int dh,
                                                int dw) {
  const int h = rb.h + dh, w = rb.w + dw;
  if (!rb.ok || h < 0 || h >= p.hs || w < 0 || w >= p.ws) return -1;
  return (rb.pix0 + (long long)h * p.ws + w) * p.cs;
}

// The output element offset (channel 0) of GEMM row r of class c.
__device__ __forceinline__ long long out_offset(const ConvPlan& p, const ConvClass& c, int r) {
  const int hw = p.gh * p.gw;
  const int b = r / hw;
  const int q = r - b * hw;
  const int i = q / p.gw, j = q - i * p.gw;
  return (((long long)b * p.oh + i * p.os + c.oph) * p.ow + j * p.os + c.opw) * p.cout;
}

// The epilogue's operands: out[o] = v (+ res[o] where the class adds it);
// act[o] = rnd(relu(v * sc[c] + sh[c])) when act is set; the statistics of
// v per 128-row tile into part_mean / part_m2 [tiles, cout] when part_mean
// is set (see the header comment).
template <typename T, typename OutT, typename ResT>
struct Epilogue {
  OutT* out;
  const ResT* res;
  T* act;
  const float* sc;
  const float* sh;
  float* part_mean;
  float* part_m2;
};

template <typename T, typename OutT, typename ResT>
__device__ __forceinline__ void store_one(const Epilogue<T, OutT, ResT>& e, bool add_res,
                                          long long o, int c, float v) {
  if (add_res) v += to_f(e.res[o]);
  e.out[o] = from_f<OutT>(v);
  if (e.act) e.act[o] = from_f<T>(fmaxf(fmaf(v, e.sc[c], e.sh[c]), 0.f));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, const float4& v) {
  __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(q);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Outputs c .. c + 3 of one row (o: the row's offset) from v: 16- or
// 8-byte accesses where all four lie inside a cout that is a multiple of
// 4 (they are then aligned), else one at a time.
template <typename T, typename OutT, typename ResT>
__device__ __forceinline__ void store_four(const Epilogue<T, OutT, ResT>& e, bool add,
                                           long long o, int c, int cout, float4 v) {
  if (c + 3 >= cout || (cout & 3)) {
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u < cout) store_one(e, add, o + c + u, c + u, w[u]);
    return;
  }
  if (add) {
    const float4 r = load4(e.res + o + c);
    v.x += r.x;
    v.y += r.y;
    v.z += r.z;
    v.w += r.w;
  }
  store4(e.out + o + c, v);
  if (e.act)
    store4(e.act + o + c, make_float4(fmaxf(fmaf(v.x, e.sc[c], e.sh[c]), 0.f),
                                      fmaxf(fmaf(v.y, e.sc[c + 1], e.sh[c + 1]), 0.f),
                                      fmaxf(fmaf(v.z, e.sc[c + 2], e.sh[c + 2]), 0.f),
                                      fmaxf(fmaf(v.w, e.sc[c + 3], e.sh[c + 3]), 0.f)));
}

// ---------------------------------------------------------------------------
// bf16: wgmma.
// ---------------------------------------------------------------------------

constexpr int H_BK = 64;     // K chunk of the conv GEMM (channels) and of the
                             // weight gradient (pixels)
constexpr int H_STAGES = 3;  // ring depth: 96 KB at BN = 128, two CTAs an SM
constexpr int H_AHEAD = 2;   // chunks loaded ahead of the one that multiplies
// wgmma groups left in flight at the end of a chunk: each stage is free
// once its group is done, so STAGES = AHEAD + 1 + IN_FLIGHT
constexpr int H_IN_FLIGHT = H_STAGES - H_AHEAD - 1;

// A wgmma shared-memory descriptor of the 128-byte swizzled layout: start
// address, lbo and sbo (bytes, stored in 16-byte units), layout type 1.
// Operands are stored in 1024-byte atoms of eight 128-byte lines; the
// 16-byte chunk c of line l sits at chunk c ^ l. K-major (64 bf16 of K per
// line): sbo is the stride between 8-row atoms, lbo unused; a 16-deep K
// step advances the start by 32 bytes. MN-major (64 bf16 of M or N per
// line, one line per K index): sbo is the stride between 8-deep K atoms,
// lbo between 64-wide M or N blocks; a K step advances by 2 sbo.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of 16-byte chunk `chunk` (of 8) of line `line` in a tile of
// 1024-byte swizzled atoms, `atom` atoms in: the layouts above.
__device__ __forceinline__ int sw128(int atom, int line, int chunk) {
  return atom * 1024 + (line & 7) * 128 + ((chunk ^ line) & 7) * 16;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (cp.async and plain stores)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from touching the accumulators across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A * B over one 64 x 64 x 16 step (one warpgroup): A and B from
// shared memory through descriptors, TA / TB the transpose flags (0:
// K-major, 1: MN-major), fp32 accumulators in registers.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %34, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// d += A * B over one 64 x 128 x 16 step (one warpgroup): A and B from
// shared memory through descriptors, TA / TB the transpose flags (0:
// K-major, 1: MN-major), fp32 accumulators in registers.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db);
  else
    wgmma_n64<TA, TB>(d, da, db);
}

template <int BN>
struct HTile {
  static constexpr int A_BYTES = GEMM_BM * H_BK * 2;
  static constexpr int B_BYTES = H_BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = H_STAGES * STAGE;
};

// The conv GEMM in bf16: out tile [128 rows, BN channels] of class
// blockIdx.z. Shared memory per stage, 128-byte swizzled: A (im2col)
// K-major, one line per row (its 64 channels of the chunk), atom r / 8;
// B (weights) MN-major, one line per K row and 64 channels, atom
// (n / 64) * 8 + k / 8. Warpgroup w multiplies rows 64 w .. 64 w + 63.
// STATS: the statistics epilogue.
template <int BN, typename OutT, typename ResT, bool STATS>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
    conv_gemm_sm90_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wt,
                          const __grid_constant__ ConvPlan p, Epilogue<bf16, OutT, ResT> e) {
  using Tile = HTile<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const ConvClass& cl = p.cls[blockIdx.z];
  const int rows = p.n * p.gh * p.gw;
  const int m0 = blockIdx.x * GEMM_BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int nk = cl.ntaps * ((p.cs + H_BK - 1) / H_BK);
  // A loader: one row, four 8-channel groups; its pixel is computed once
  const int ar = tid >> 1, ag0 = (tid & 1) * 4;
  const RowBase rb = row_base(p, m0 + ar, rows);
  const bool avec = (p.cs % 8) == 0;
  // B loader: one weight row of the chunk, BN / 32 groups of 8 channels
  constexpr int BG = BN / 32;
  const int bk = tid >> 2, bg0 = (tid & 3) * BG;
  const bool bvec = (p.cout % 8) == 0;

  int ld_k = 0, ld_t = 0, ld_c = 0;  // next chunk: index, tap, first channel
  auto issue = [&](int stage) {
    if (ld_k < nk) {
      unsigned char* sa = smem + stage * Tile::STAGE;
      unsigned char* sb = sa + Tile::A_BYTES;
      const Tap tp = cl.tap[ld_t];
      const long long so = src_offset(p, rb, tp.dh, tp.dw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int g = ag0 + q, c = ld_c + g * 8;
        const int nv = so < 0 ? 0 : clamp_valid(p.cs - c, 8);
        load_group(reinterpret_cast<bf16*>(sa + sw128(ar >> 3, ar, g)),
                   nv ? src + so + c : src, nv, avec, src);
      }
      const int kc = ld_c + bk;
      const bf16* wrow = wt + (long long)(tp.wrow + (kc < p.cs ? kc : 0)) * p.cout;
#pragma unroll
      for (int q = 0; q < BG; ++q) {
        const int g = bg0 + q, c = n0 + g * 8;
        const int nv = kc < p.cs ? clamp_valid(p.cout - c, 8) : 0;
        load_group(reinterpret_cast<bf16*>(sb + sw128((g >> 3) * 8 + (bk >> 3), bk, g)),
                   nv ? wrow + c : wt, nv, bvec, wt);
      }
      ld_c += H_BK;
      if (ld_c >= p.cs) {
        ld_c = 0;
        ++ld_t;
      }
    }
    ++ld_k;
    cp_async_commit();
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;
#pragma unroll
  for (int s = 0; s < H_AHEAD; ++s) issue(s);
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();  // every warpgroup is done with the stage this refills
    issue((kc + H_AHEAD) % H_STAGES);
    cp_async_wait<H_AHEAD>();
    fence_proxy_async();
    __syncthreads();  // chunk kc is in shared memory
    const unsigned char* sa = smem + (kc % H_STAGES) * Tile::STAGE;
    const unsigned char* sb = sa + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks)
      wgmma_bn<BN, 0, 1>(acc, gmma_desc(sa + wg * 8192 + ks * 32, 16, 1024),
                         gmma_desc(sb + ks * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait<H_IN_FLIGHT>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // The tile goes through shared memory (the ring is free now), so the
  // stores are 16 bytes a thread along each output row. Accumulator
  // fragment: d[4 j + 2 h + b] is row 16 (warp % 4) + lane / 4 + 8 h of
  // the warpgroup's 64, column 8 j + 2 (lane % 4) + b.
  constexpr int LD = BN + 4;
  static_assert(GEMM_BM * LD * 4 <= Tile::SMEM, "the output tile fits in the ring");
  float* ct = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, warp = tid >> 5;
  const int fr = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(ct + (fr + 8 * h) * LD + j * 8 + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  constexpr int TPR = BN / 4;  // threads a row
  const bool add = e.res != nullptr && cl.residual;
  const int cq = (tid % TPR) * 4;
  for (int lr = tid / TPR; lr < GEMM_BM; lr += GEMM_THREADS / TPR) {
    const int r = m0 + lr;
    if (r >= rows) break;
    if (n0 + cq >= p.cout) continue;
    store_four(e, add, out_offset(p, cl, r), n0 + cq, p.cout,
               *reinterpret_cast<const float4*>(ct + lr * LD + cq));
  }
  if constexpr (STATS) {
    // G row lanes a channel, each summing every G-th valid row in order;
    // the lanes combined in order
    constexpr int G = GEMM_THREADS / BN;
    static_assert((GEMM_BM * LD + (G + 1) * BN) * 4 <= Tile::SMEM, "the sums fit beside the tile");
    float* red = ct + GEMM_BM * LD;  // [G][BN]
    float* tmean = red + G * BN;     // [BN]
    const int nrows = min(GEMM_BM, rows - m0);
    const int c = tid % BN, q = tid / BN;
    float sum = 0.f;
    for (int r = q; r < nrows; r += G) sum += ct[r * LD + c];
    red[q * BN + c] = sum;
    __syncthreads();
    if (tid < BN) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) t += red[k * BN + tid];
      tmean[tid] = t / (float)nrows;
    }
    __syncthreads();
    const float mu = tmean[c];
    float m2 = 0.f;
    for (int r = q; r < nrows; r += G) {
      const float d = ct[r * LD + c] - mu;
      m2 = fmaf(d, d, m2);
    }
    red[q * BN + c] = m2;
    __syncthreads();
    if (tid < BN && n0 + tid < p.cout) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) t += red[k * BN + tid];
      const long long o = (long long)blockIdx.x * p.cout + n0 + tid;
      e.part_mean[o] = tmean[tid];
      e.part_m2[o] = t;
    }
  }
}

// The weight gradient in bf16: part[z, k, c] = sum over the pixels m of
// split z of A[m, k] * dy[m, c], A the im2col of src (class 0 of p, a
// forward conv), over a padded K of ntaps * roundup(cs, 8) rows, 128 of
// them per CTA. The pixels are the MMA's K, so both operands are MN-major
// in shared memory, 128-byte swizzled: one line per pixel and 64 weight
// rows (A) or channels (dy), atom (64-block) * 8 + px / 8.
template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
    conv_wgrad_sm90_kernel(const bf16* __restrict__ src, const bf16* __restrict__ dy,
                           float* __restrict__ part, const __grid_constant__ ConvPlan p,
                           int m_per) {
  using Tile = HTile<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const ConvClass& cl = p.cls[0];
  const int rows = p.n * p.gh * p.gw;
  const int csp = (p.cs + 7) & ~7;
  const int k0 = blockIdx.x * GEMM_BM, c0 = blockIdx.y * BN;
  const int mb = blockIdx.z * m_per;
  const int me = min(rows, mb + m_per);
  const int tid = threadIdx.x;
  const int nk = (me - mb + H_BK - 1) / H_BK;
  // A loader: one pixel, four 8-row groups of K with their taps fixed
  const int ap = tid >> 2, ag0 = (tid & 3) * 4;
  int gdh[4], gdw[4], gch[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kr = k0 + (ag0 + q) * 8;
    const int t = kr / csp;
    gch[q] = t < cl.ntaps ? kr - t * csp : -1;
    gdh[q] = t < cl.ntaps ? cl.tap[t].dh : 0;
    gdw[q] = t < cl.ntaps ? cl.tap[t].dw : 0;
  }
  const bool avec = (p.cs % 8) == 0;
  // dy loader: the same pixel, BN / 32 groups of 8 channels
  constexpr int DG = BN / 32;
  const int dg0 = (tid & 3) * DG;
  const bool dvec = (p.cout % 8) == 0;

  int ld_k = 0;
  auto issue = [&](int stage) {
    if (ld_k < nk) {
      unsigned char* sa = smem + stage * Tile::STAGE;
      unsigned char* sd = sa + Tile::A_BYTES;
      const int m = mb + ld_k * H_BK + ap;
      const RowBase rb = row_base(p, m, me);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long so = gch[q] < 0 ? -1 : src_offset(p, rb, gdh[q], gdw[q]);
        const int nv = so < 0 ? 0 : clamp_valid(p.cs - gch[q], 8);
        const int g = ag0 + q;
        load_group(reinterpret_cast<bf16*>(sa + sw128((g >> 3) * 8 + (ap >> 3), ap, g)),
                   nv ? src + so + gch[q] : src, nv, avec, src);
      }
      const bf16* drow = dy + (long long)(m < me ? m : 0) * p.cout;
#pragma unroll
      for (int q = 0; q < DG; ++q) {
        const int c = c0 + (dg0 + q) * 8;
        const int nv = m < me ? clamp_valid(p.cout - c, 8) : 0;
        const int g = dg0 + q;
        load_group(reinterpret_cast<bf16*>(sd + sw128((g >> 3) * 8 + (ap >> 3), ap, g)),
                   nv ? drow + c : dy, nv, dvec, dy);
      }
    }
    ++ld_k;
    cp_async_commit();
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;
#pragma unroll
  for (int s = 0; s < H_AHEAD; ++s) issue(s);
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();
    issue((kc + H_AHEAD) % H_STAGES);
    cp_async_wait<H_AHEAD>();
    fence_proxy_async();
    __syncthreads();
    const unsigned char* sa = smem + (kc % H_STAGES) * Tile::STAGE;
    const unsigned char* sd = sa + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks)
      wgmma_bn<BN, 1, 1>(acc, gmma_desc(sa + wg * 8192 + ks * 2048, 8192, 1024),
                         gmma_desc(sd + ks * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait<H_IN_FLIGHT>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int lane = tid & 31, warp = tid >> 5;
  const long long kreal = (long long)cl.ntaps * p.cs;
  const int r0 = k0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = r0 + 8 * h;
    const int t = kr / csp, ch = kr - t * csp;
    if (t >= cl.ntaps || ch >= p.cs) continue;
    float* prow = part + ((long long)blockIdx.z * kreal + cl.tap[t].wrow + ch) * p.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + j * 8 + 2 * (lane & 3);
      if (c + 1 < p.cout && !(p.cout & 1)) {
        store2(prow + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        if (c < p.cout) prow[c] = acc[4 * j + 2 * h];
        if (c + 1 < p.cout) prow[c + 1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int F_BK = 16;         // K chunk (channels, or pixels of the weight gradient)
constexpr int F_STAGES = 3;      // ring depth
constexpr int F_ALD = F_BK + 4;  // A row pitch of the conv GEMM (floats)

template <int BN>
struct FTile {
  static constexpr int A_FLOATS = GEMM_BM * F_ALD;
  static constexpr int B_FLOATS = F_BK * BN;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = F_STAGES * STAGE * 4;
};

template <int BN>
struct FWTile {  // weight gradient: A [16 px][128 k], dy [16 px][BN]
  static constexpr int A_FLOATS = F_BK * GEMM_BM;
  static constexpr int STAGE = A_FLOATS + F_BK * BN;
  static constexpr int SMEM = F_STAGES * STAGE * 4;
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The conv GEMM in fp32: out tile [128 rows, BN channels] of class
// blockIdx.z; thread (tx, ty) of a 16 x 16 grid owns rows ty + 16 i (i < 8)
// and columns 4 tx + 64 jj .. + 3 (jj < BN / 64). A is stored row-major
// with a padded pitch (its float4 reads along K broadcast within a warp),
// B as [16 k][BN]. STATS: the statistics epilogue.
template <int BN, bool STATS>
__global__ void __launch_bounds__(GEMM_THREADS)
    conv_gemm_f32_kernel(const float* __restrict__ src, const float* __restrict__ wt,
                         const __grid_constant__ ConvPlan p, Epilogue<float, float, float> e) {
  using Tile = FTile<BN>;
  constexpr int JN = BN / 64;
  extern __shared__ __align__(16) float fsmem[];
  const ConvClass& cl = p.cls[blockIdx.z];
  const int rows = p.n * p.gh * p.gw;
  const int m0 = blockIdx.x * GEMM_BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nk = cl.ntaps * ((p.cs + F_BK - 1) / F_BK);
  // A loader: one row, two 4-channel groups; its pixel is computed once
  const int ar = tid >> 1, ag0 = (tid & 1) * 2;
  const RowBase rb = row_base(p, m0 + ar, rows);
  const bool avec = (p.cs % 4) == 0;
  // B loader: one weight row of the chunk, JN groups of 4 channels
  const int bk = tid >> 4, bg0 = (tid & 15) * JN;
  const bool bvec = (p.cout % 4) == 0;

  int ld_k = 0, ld_t = 0, ld_c = 0;
  auto issue = [&](int stage) {
    if (ld_k < nk) {
      float* sa = fsmem + stage * Tile::STAGE;
      float* sb = sa + Tile::A_FLOATS;
      const Tap tp = cl.tap[ld_t];
      const long long so = src_offset(p, rb, tp.dh, tp.dw);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int g = ag0 + q, c = ld_c + g * 4;
        const int nv = so < 0 ? 0 : clamp_valid(p.cs - c, 4);
        load_group(sa + ar * F_ALD + g * 4, nv ? src + so + c : src, nv, avec, src);
      }
      const int kc = ld_c + bk;
      const float* wrow = wt + (long long)(tp.wrow + (kc < p.cs ? kc : 0)) * p.cout;
#pragma unroll
      for (int q = 0; q < JN; ++q) {
        const int g = bg0 + q, c = n0 + g * 4;
        const int nv = kc < p.cs ? clamp_valid(p.cout - c, 4) : 0;
        load_group(sb + bk * BN + g * 4, nv ? wrow + c : wt, nv, bvec, wt);
      }
      ld_c += F_BK;
      if (ld_c >= p.cs) {
        ld_c = 0;
        ++ld_t;
      }
    }
    ++ld_k;
    cp_async_commit();
  };

  float acc[8][4 * JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * JN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) issue(s);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // chunk kc landed; chunk kc - 1's stage is free
    issue((kc + F_STAGES - 1) % F_STAGES);
    const float* sa = fsmem + (kc % F_STAGES) * Tile::STAGE;
    const float* sb = sa + Tile::A_FLOATS;
#pragma unroll
    for (int kb = 0; kb < F_BK; kb += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * F_ALD + kb);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 b[JN];
#pragma unroll
        for (int jj = 0; jj < JN; ++jj)
          b[jj] = *reinterpret_cast<const float4*>(sb + (kb + u) * BN + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = comp(a[i], u);
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) {
            acc[i][4 * jj + 0] = fmaf(av, b[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(av, b[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(av, b[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(av, b[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool add = e.res != nullptr && cl.residual;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= rows) continue;
    const long long o = out_offset(p, cl, r);
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      const int c = n0 + tx * 4 + 64 * jj;
      if (c >= p.cout) continue;
      store_four(e, add, o, c, p.cout,
                     make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2],
                                 acc[i][4 * jj + 3]));
    }
  }
  if constexpr (STATS) {
    // each thread's 8 rows in registers, then the 16 row lanes (ty)
    // combined in order through shared memory
    static_assert((16 + 1) * BN * 4 <= Tile::SMEM, "the sums fit in the ring");
    float* red = fsmem;              // [16][BN]
    float* tmean = fsmem + 16 * BN;  // [BN]
    const int nrows = min(GEMM_BM, rows - m0);
    float part[4 * JN];
#pragma unroll
    for (int j = 0; j < 4 * JN; ++j) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (ty + 16 * i < nrows) t += acc[i][j];
      part[j] = t;
    }
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
      store4(red + ty * BN + tx * 4 + 64 * jj,
             make_float4(part[4 * jj], part[4 * jj + 1], part[4 * jj + 2], part[4 * jj + 3]));
    __syncthreads();
    if (tid < BN) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) t += red[k * BN + tid];
      tmean[tid] = t / (float)nrows;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4 * JN; ++j) {
      const float mu = tmean[tx * 4 + 64 * (j / 4) + j % 4];
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (ty + 16 * i < nrows) {
          const float d = acc[i][j] - mu;
          q = fmaf(d, d, q);
        }
      part[j] = q;
    }
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
      store4(red + ty * BN + tx * 4 + 64 * jj,
             make_float4(part[4 * jj], part[4 * jj + 1], part[4 * jj + 2], part[4 * jj + 3]));
    __syncthreads();
    if (tid < BN && n0 + tid < p.cout) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) t += red[k * BN + tid];
      const long long o = (long long)blockIdx.x * p.cout + n0 + tid;
      e.part_mean[o] = tmean[tid];
      e.part_m2[o] = t;
    }
  }
}

// The weight gradient in fp32: part[z, k, c] over the pixels of split z,
// 128 padded K rows (ntaps * roundup(cs, 4)) x BN channels per CTA, 16
// pixels per stage. Thread (tx, ty) owns K rows 4 ty + i and 64 + 4 ty + i
// (i < 4) and channels 4 tx + 64 jj .. + 3: per pixel two float4 reads of
// A and JN of dy feed 32 JN FMAs.
template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS)
    conv_wgrad_f32_kernel(const float* __restrict__ src, const float* __restrict__ dy,
                          float* __restrict__ part, const __grid_constant__ ConvPlan p,
                          int m_per) {
  using Tile = FWTile<BN>;
  constexpr int JN = BN / 64;
  extern __shared__ __align__(16) float fsmem[];
  const ConvClass& cl = p.cls[0];
  const int rows = p.n * p.gh * p.gw;
  const int csp = (p.cs + 3) & ~3;
  const int k0 = blockIdx.x * GEMM_BM, c0 = blockIdx.y * BN;
  const int mb = blockIdx.z * m_per;
  const int me = min(rows, mb + m_per);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nk = (me - mb + F_BK - 1) / F_BK;
  // A loader: one pixel, two 4-row groups of K with their taps fixed
  const int ap = tid >> 4, ag0 = (tid & 15) * 2;
  int gdh[2], gdw[2], gch[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int kr = k0 + (ag0 + q) * 4;
    const int t = kr / csp;
    gch[q] = t < cl.ntaps ? kr - t * csp : -1;
    gdh[q] = t < cl.ntaps ? cl.tap[t].dh : 0;
    gdw[q] = t < cl.ntaps ? cl.tap[t].dw : 0;
  }
  const bool avec = (p.cs % 4) == 0;
  const int dg0 = (tid & 15) * JN;
  const bool dvec = (p.cout % 4) == 0;

  int ld_k = 0;
  auto issue = [&](int stage) {
    if (ld_k < nk) {
      float* sa = fsmem + stage * Tile::STAGE;
      float* sd = sa + Tile::A_FLOATS;
      const int m = mb + ld_k * F_BK + ap;
      const RowBase rb = row_base(p, m, me);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const long long so = gch[q] < 0 ? -1 : src_offset(p, rb, gdh[q], gdw[q]);
        const int nv = so < 0 ? 0 : clamp_valid(p.cs - gch[q], 4);
        load_group(sa + ap * GEMM_BM + (ag0 + q) * 4, nv ? src + so + gch[q] : src, nv, avec,
                   src);
      }
      const float* drow = dy + (long long)(m < me ? m : 0) * p.cout;
#pragma unroll
      for (int q = 0; q < JN; ++q) {
        const int c = c0 + (dg0 + q) * 4;
        const int nv = m < me ? clamp_valid(p.cout - c, 4) : 0;
        load_group(sd + ap * BN + (dg0 + q) * 4, nv ? drow + c : dy, nv, dvec, dy);
      }
    }
    ++ld_k;
    cp_async_commit();
  };

  float acc[8][4 * JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * JN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) issue(s);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    issue((kc + F_STAGES - 1) % F_STAGES);
    const float* sa = fsmem + (kc % F_STAGES) * Tile::STAGE;
    const float* sd = sa + Tile::A_FLOATS;
#pragma unroll
    for (int mm = 0; mm < F_BK; ++mm) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + mm * GEMM_BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + mm * GEMM_BM + 64 + ty * 4);
      float4 b[JN];
#pragma unroll
      for (int jj = 0; jj < JN; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(sd + mm * BN + tx * 4 + 64 * jj);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = comp(i < 4 ? a0 : a1, i & 3);
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) {
          acc[i][4 * jj + 0] = fmaf(av, b[jj].x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(av, b[jj].y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(av, b[jj].z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(av, b[jj].w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long kreal = (long long)cl.ntaps * p.cs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kr = k0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const int t = kr / csp, ch = kr - t * csp;
    if (t >= cl.ntaps || ch >= p.cs) continue;
    float* prow = part + ((long long)blockIdx.z * kreal + cl.tap[t].wrow + ch) * p.cout;
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      const int c = c0 + tx * 4 + 64 * jj;
      if (dvec && c + 3 < p.cout) {
        *reinterpret_cast<float4*>(prow + c) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < p.cout) prow[c + u] = acc[i][4 * jj + u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: plans and launches.
// ---------------------------------------------------------------------------

constexpr int WGRAD_CTAS = 4 * 132;  // CTAs the weight-gradient row split aims for

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline ConvPlan plan_grid(int n, int hs, int ws, int cs, int gh, int gw, int ss, int oh, int ow,
                          int os, int cout) {
  ConvPlan p = {};
  p.n = n; p.hs = hs; p.ws = ws; p.cs = cs;
  p.gh = gh; p.gw = gw; p.ss = ss;
  p.oh = oh; p.ow = ow; p.os = os;
  p.cout = cout;
  return p;
}

inline void add_tap(ConvClass& c, int dh, int dw, int wrow) {
  c.tap[c.ntaps].dh = dh;
  c.tap[c.ntaps].dw = dw;
  c.tap[c.ntaps].wrow = wrow;
  ++c.ntaps;
}

// A forward conv of src [n, hi, wi, cin] (HWIO or [cin, cout] weights, pad
// (ks - 1) / 2, stride s; the output grid hi / s x wi / s): one class.
inline ConvPlan forward_plan(int n, int hi, int wi, int cin, int ks, int s, int cout) {
  const int pad = (ks - 1) / 2;
  ConvPlan p = plan_grid(n, hi, wi, cin, hi / s, wi / s, s, hi / s, wi / s, 1, cout);
  p.nclass = 1;
  p.cls[0].residual = 1;
  for (int kh = 0; kh < ks; ++kh)
    for (int kw = 0; kw < ks; ++kw) add_tap(p.cls[0], kh - pad, kw - pad, (kh * ks + kw) * cin);
  return p;
}

// The data gradient of a 3x3 pad-1 conv of stride s from dy [n, ho, wo, c]
// and the weights with their channel axes swapped ([3, 3, c, cout]) into
// the input grid [n, hi, wi, cout]. Input pixel ih takes dy[th / s] through
// tap kh where th = ih + 1 - kh is a multiple of s. At s = 2 the input grid
// splits into four parity classes (ph, pw), each an ho x wo grid with only
// the taps kh = 1 (ph = 0) or kh = 0, 2 (ph = 1), reading dy at
// i + (ph + 1 - kh) / 2. even_even_residual: at s = 2 only class (0, 0)
// adds the epilogue's residual, for a residual written at the even-even
// pixels alone (the 1x1/s2 shortcut's share of dx, shortcut_dx_plan); the
// other classes never read it, so its odd pixels may hold anything. Else
// (and always at s = 1, one class) every class adds it.
inline ConvPlan transposed3_plan(int n, int ho, int wo, int c, int hi, int wi, int cout, int s,
                                 bool even_even_residual = false) {
  if (s == 1) {
    ConvPlan p = plan_grid(n, ho, wo, c, hi, wi, 1, hi, wi, 1, cout);
    p.nclass = 1;
    p.cls[0].residual = 1;
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw) add_tap(p.cls[0], 1 - kh, 1 - kw, (kh * 3 + kw) * c);
    return p;
  }
  ConvPlan p = plan_grid(n, ho, wo, c, ho, wo, 1, hi, wi, 2, cout);
  p.nclass = 4;
  for (int ph = 0; ph < 2; ++ph)
    for (int pw = 0; pw < 2; ++pw) {
      ConvClass& cl = p.cls[ph * 2 + pw];
      cl.oph = ph;
      cl.opw = pw;
      cl.residual = !even_even_residual || (ph == 0 && pw == 0);
      for (int kh = 0; kh < 3; ++kh) {
        if (((ph + 1 - kh) & 1) != 0) continue;
        for (int kw = 0; kw < 3; ++kw) {
          if (((pw + 1 - kw) & 1) != 0) continue;
          add_tap(cl, (ph + 1 - kh) / 2, (pw + 1 - kw) / 2, (kh * 3 + kw) * c);
        }
      }
    }
  return p;
}

// dx = dy1 k1^T over the input grid [n, hi, wi]: one class at s = 1; at
// s = 2 the four parity classes of the grid, with the residual (the
// shortcut's share, which the 1x1/s2 puts on even-even pixels only) in
// class (0, 0) alone.
inline ConvPlan pointwise_dx_plan(int n, int hi, int wi, int c, int cout, int s) {
  if (s == 1) return forward_plan(n, hi, wi, c, 1, 1, cout);
  ConvPlan p = plan_grid(n, hi, wi, c, hi / 2, wi / 2, 2, hi, wi, 2, cout);
  p.nclass = 4;
  for (int ph = 0; ph < 2; ++ph)
    for (int pw = 0; pw < 2; ++pw) {
      ConvClass& cl = p.cls[ph * 2 + pw];
      cl.oph = ph;
      cl.opw = pw;
      cl.residual = ph == 0 && pw == 0;
      add_tap(cl, ph, pw, 0);
    }
  return p;
}

// The shortcut's share of dx, dyS kst over the dy grid [n, ho, wo] written
// to the input grid's pixels (s i, s j): at s = 2 the even-even class only.
inline ConvPlan shortcut_dx_plan(int n, int ho, int wo, int c, int hi, int wi, int cout, int s) {
  ConvPlan p = plan_grid(n, ho, wo, c, ho, wo, 1, hi, wi, s, cout);
  p.nclass = 1;
  p.cls[0].residual = 1;
  add_tap(p.cls[0], 0, 0, 0);
  return p;
}

template <typename T>
constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

template <typename K, typename... A>
cudaError_t launch(K kernel, dim3 grid, int smem, cudaStream_t st, A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, GEMM_THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

template <bool STATS, typename T, typename OutT, typename ResT>
cudaError_t conv_gemm_launch(const ConvPlan& p, const T* src, const T* wt,
                             const Epilogue<T, OutT, ResT>& e, cudaStream_t st) {
  const int rows = p.n * p.gh * p.gw;
  const bool wide = p.cout > 64;
  const dim3 grid(cdiv(rows, GEMM_BM), cdiv(p.cout, wide ? 128 : 64), p.nclass);
  if constexpr (is_f32<T>()) {
    if (wide)
      return launch(conv_gemm_f32_kernel<128, STATS>, grid, FTile<128>::SMEM, st, src, wt, p, e);
    return launch(conv_gemm_f32_kernel<64, STATS>, grid, FTile<64>::SMEM, st, src, wt, p, e);
  } else {
    if (wide)
      return launch(conv_gemm_sm90_kernel<128, OutT, ResT, STATS>, grid, HTile<128>::SMEM, st, src,
                    wt, p, e);
    return launch(conv_gemm_sm90_kernel<64, OutT, ResT, STATS>, grid, HTile<64>::SMEM, st, src, wt,
                  p, e);
  }
}

// out (+ res) = the conv of plan p, with act = rnd(relu(out * sc + sh))
// when e.act is set and the tile statistics when e.part_mean is set (a
// one-class plan with fp32 out and no residual, else cudaErrorInvalidValue);
// on the caller's stream.
template <typename T, typename OutT, typename ResT>
cudaError_t conv_gemm(const ConvPlan& p, const T* src, const T* wt,
                      const Epilogue<T, OutT, ResT>& e, cudaStream_t st) {
  if (!e.part_mean) return conv_gemm_launch<false>(p, src, wt, e, st);
  if constexpr (std::is_same<OutT, float>::value) {
    if (p.nclass != 1 || e.res || !e.part_m2) return cudaErrorInvalidValue;
    return conv_gemm_launch<true>(p, src, wt, e, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

// The weight gradient's row split: pixels per split, a whole number of
// K chunks, enough splits to fill about WGRAD_CTAS CTAs.
template <typename T>
int wgrad_rows_per_split(const ConvPlan& p) {
  const int chunk = is_f32<T>() ? F_BK : H_BK;
  const int v = Vec<T>::N;
  const long long rows = (long long)p.n * p.gh * p.gw;
  const int kpad = p.cls[0].ntaps * ((p.cs + v - 1) / v * v);
  const int ctas = cdiv(kpad, GEMM_BM) * cdiv(p.cout, p.cout > 64 ? 128 : 64);
  const int chunks = cdiv(rows, chunk);
  int splits = cdiv(WGRAD_CTAS, ctas);
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  return cdiv(chunks, splits) * chunk;
}

template <typename T>
int wgrad_splits(const ConvPlan& p) {
  return cdiv((long long)p.n * p.gh * p.gw, wgrad_rows_per_split<T>(p));
}

// Floats of the partials buffer: splits x (ntaps cs) x cout.
template <typename T>
size_t wgrad_part_floats(const ConvPlan& p) {
  return (size_t)wgrad_splits<T>(p) * p.cls[0].ntaps * p.cs * p.cout;
}

// part[z, k, c] for every split z of the rows (wgrad_splits of them).
template <typename T>
cudaError_t conv_wgrad(const ConvPlan& p, const T* src, const T* dy, float* part,
                       cudaStream_t st) {
  const int v = Vec<T>::N;
  const int kpad = p.cls[0].ntaps * ((p.cs + v - 1) / v * v);
  const bool wide = p.cout > 64;
  const int m_per = wgrad_rows_per_split<T>(p);
  const dim3 grid(cdiv(kpad, GEMM_BM), cdiv(p.cout, wide ? 128 : 64), wgrad_splits<T>(p));
  if constexpr (is_f32<T>()) {
    if (wide)
      return launch(conv_wgrad_f32_kernel<128>, grid, FWTile<128>::SMEM, st, src, dy, part, p,
                    m_per);
    return launch(conv_wgrad_f32_kernel<64>, grid, FWTile<64>::SMEM, st, src, dy, part, p, m_per);
  } else {
    if (wide)
      return launch(conv_wgrad_sm90_kernel<128>, grid, HTile<128>::SMEM, st, src, dy, part, p,
                    m_per);
    return launch(conv_wgrad_sm90_kernel<64>, grid, HTile<64>::SMEM, st, src, dy, part, p, m_per);
  }
}

}  // namespace sm90
