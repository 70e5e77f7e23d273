// Folded CBN-decoder MLP, bf16 matmul inputs with f32 sums, on Hopper's
// tensor cores: points (P, 3) -> UDF (P,).
//
// Replaces the TPU kernel `_decoder_kernel` / `pallas_folded_udf` of
// surfd_tpu/ops/decoder_kernel.py (retired in commit a9ab519) in its own
// math: bf16 inputs to every matmul, f32 accumulation, an f32 affine/ReLU
// chain. The live reference is `folded_udf_mixed` there; the plain version
// here is `folded_udf_mixed_ref` in ops/decoder_kernel.py, which also holds
// the host-side packing this kernel reads. The f32 variant stays on the FP32
// pipes in folded_mlp.cu.
//
// What bounds it on an H100. At H = 512, L = 5 a point costs about 2.65 M
// multiply-adds, 5.6 ms of bf16 tensor-core time at 2^20 points. The 5.3 MB
// of packed bf16 weights stay in the 50 MB L2, but every 64-point CTA
// streams all of them from L2: about 87 GB of L2 reads at 2^20 points, which
// at 5-7 TB/s of L2 bandwidth is 12-17 ms. So the L2 weight stream, not the
// tensor cores, is the bound this design meets.
//
// Design. One CTA of two consumer warpgroups (256 threads) takes 64 points,
// one wgmma M tile, and keeps every activation on the SM:
// - the f32 residual stream x lives in registers, in the accumulator layout
//   of the wgmma chunk that produced it (`frag_row`/`frag_col`);
// - the bf16 matmul inputs live in shared memory, `act0` (relu(a1*x + c1))
//   and `act1` (the block's hidden h, or the positional encoding at first);
// - each weight streams from L2 as K-slabs of 64 rows x NP columns (one
//   "pass" of output columns, NP = min(256, H)); warpgroup g multiplies the
//   slab's columns [g*NP/2, (g+1)*NP/2) with m64n{NP/2}k16 wgmma, both
//   operands in shared memory, no swizzle;
// - a 2-stage ring of slabs is filled with 16-byte cp.async copies by all
//   256 threads; slab s+1 loads while slab s multiplies;
// - the epilogue of each pass adds the bias, applies the next affine/ReLU and
//   writes bf16 into the other activation buffer, or updates x in registers
//   as (x + acc) + b2, `folded_udf_mixed`'s association;
// - the output projection stays on FFMA: bf16-rounded relu(a_out*x + c_out)
//   times w_out over each thread's columns, a quad shuffle sum, one sum across
//   the two warpgroups in shared memory, then (1 - sigmoid) * max_dist.
// The packed weights come in wgmma's no-swizzle K-major core-matrix layout
// (ops/decoder_kernel.py `pack_kmajor`), so each slab is one contiguous block.
// The hidden width is padded on the host to 64, 128, 256 or 512 with zero
// weights, biases and affines, which keep the padded units exactly 0.
//
// What a later design would do about the L2 stream: a 128-point tile (two M
// tiles per slab) halves it, and a cluster of CTAs sharing each slab by TMA
// multicast divides it by the cluster size.
//
// Shared memory at H = 512: act0 + act1 (64 KB each), ring 2 x 32 KB, 512 B
// for the cross-warpgroup sum: 197,120 bytes, one CTA per SM. Registers: x
// (2 passes x 64) + one accumulator (64) per thread; at H = 512 ptxas uses
// all 255 and spills a few hundred bytes.
//
// Accuracy. wgmma sums each product in its own order. Against the plain
// version (cuBLAS's FP32 GEMM order) an f32 ulp of difference in a sum can
// flip the bf16 rounding of the next layer's input, so on a trained decoder
// the two differ by as much as any two summation orders do. The tight check
// is against `folded_udf_mixed_tc`, the same math on cuBLAS's tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 64;         // points per CTA: one wgmma M tile
constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kSlabK = 64;     // K rows of one streamed weight slab
constexpr int kCore = 128;     // bytes of one core matrix: 8 rows x 16 bytes

template <int HP>
struct Cfg {
  static constexpr int NP = HP < 256 ? HP : 256;  // output columns per pass
  static constexpr int NW = NP / 2;               // columns per warpgroup per pass
  static constexpr int NPASS = HP / NP;
  static constexpr int KS = HP / kSlabK;          // slabs per pass of an H x H matmul
  static constexpr int SLAB_BYTES = NP * kSlabK * 2;
  static constexpr int ACT_BYTES = kM * HP * 2;
  static constexpr int SMEM = 2 * SLAB_BYTES + 2 * ACT_BYTES + 2 * kM * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices adjacent in K) and stride byte offset
// (between core matrices adjacent in M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Activation buffers hold a 64 x K bf16 matrix (K-major A operand) as core
// matrices ordered [k / 8][m / 8]: LBO = 8 * 128 bytes, SBO = 128 bytes.
constexpr uint32_t kActLbo = 8 * kCore, kActSbo = kCore;
// A weight slab holds NP x 64 (N x K, K-major B operand) as core matrices
// ordered [n / 8][k / 8]: LBO = 128 bytes, SBO = 8 * 128 bytes.
constexpr uint32_t kSlabLbo = kCore, kSlabSbo = 8 * kCore;

__device__ __forceinline__ int act_off(int m, int k) {
  return ((k >> 3) * 8 + (m >> 3)) * kCore + (m & 7) * 16 + (k & 7) * 2;
}

// The m64nNk16 f32 accumulator: register r of thread (warp w, lane) holds
// row 16 w + lane / 4 + 8 ((r / 2) % 2) and column 2 (lane % 4) + 8 (r / 4)
// + r % 2. row0 = 16 w + lane / 4, col0 = 2 (lane % 4).
__device__ __forceinline__ int frag_row(int r, int row0) { return row0 + 8 * ((r >> 1) & 1); }
__device__ __forceinline__ int frag_col(int r, int col0) { return col0 + 8 * (r >> 2) + (r & 1); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
// Make generic-proxy shared-memory writes (stores, cp.async) visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving accumulator reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, registers) += A (64 x 16, bf16, shared) * B (16 x N, bf16,
// shared, stored N x K); scale-d = 1, no transposes.
template <int N> struct Mma;

template <> struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ float affine_relu(float x, float a, float c) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), c), 0.0f);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float2 ld2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }

__device__ __forceinline__ void act_store(char* act, int m, int k, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(act + act_off(m, k)) = __floats2bfloat162_rn(v0, v1);
}

// act[m][n] = bf16(relu(a[n] * v[m][n] + c[n])) over this thread's fragment
// of a pass whose first column is nb.
template <int R>
__device__ __forceinline__ void emit_act(const float (&v)[R], int nb, int row0, int col0,
                                         const float* __restrict__ a, const float* __restrict__ c,
                                         char* act) {
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    const int n = nb + frag_col(r, col0);
    const float2 av = ld2(a + n), cv = ld2(c + n);
    act_store(act, frag_row(r, row0), n, affine_relu(v[r], av.x, cv.x), affine_relu(v[r + 1], av.y, cv.y));
  }
}

// part[i] += sum over this thread's columns of bf16(relu(a_out x + c_out)) * w_out
// for its rows row0 + 8 i.
template <int R>
__device__ __forceinline__ void emit_out(const float (&x)[R], int nb, int col0,
                                         const float* __restrict__ a, const float* __restrict__ c,
                                         const __nv_bfloat16* __restrict__ w, float (&part)[2]) {
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    const int n = nb + frag_col(r, col0);
    const float2 av = ld2(a + n), cv = ld2(c + n);
    const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + n));
    float& p = part[(r >> 1) & 1];
    p = fmaf(round_bf16(affine_relu(x[r], av.x, cv.x)), wv.x, p);
    p = fmaf(round_bf16(affine_relu(x[r + 1], av.y, cv.y)), wv.y, p);
  }
}

template <int HP>
__global__ void __launch_bounds__(kThreads, 1)
folded_mlp_bf16_kernel(const float* __restrict__ pts, int64_t P, int L,
                       const __nv_bfloat16* __restrict__ w_in, const float* __restrict__ b_in,
                       const float* __restrict__ a1, const float* __restrict__ c1,
                       const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ a2, const float* __restrict__ c2,
                       const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ a_out, const float* __restrict__ c_out,
                       const __nv_bfloat16* __restrict__ w_out, float b_out, float max_dist,
                       float* __restrict__ out) {
  using C = Cfg<HP>;
  constexpr int R = C::NW / 2;  // accumulator registers per thread
  extern __shared__ __align__(128) char smem[];
  char* ring = smem;  // 2 slabs
  char* act0 = smem + 2 * C::SLAB_BYTES;
  char* act1 = act0 + C::ACT_BYTES;
  float* red = reinterpret_cast<float*>(act1 + C::ACT_BYTES);  // [2][kM]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int64_t p0 = (int64_t)blockIdx.x * kM;

  // The slab stream: w_in (NPASS slabs), then per block w1 and w2 (NPASS x KS
  // slabs each), each matrix packed pass-major, slab-minor.
  const int per_mat = C::NPASS * C::KS;
  const int total = C::NPASS + 2 * L * per_mat;
  auto load_slab = [&](int s) {
    if (s < total) {
      const char* src;
      if (s < C::NPASS) {
        src = reinterpret_cast<const char*>(w_in) + (size_t)s * C::SLAB_BYTES;
      } else {
        const int u = s - C::NPASS, l = u / (2 * per_mat), q = u % (2 * per_mat);
        const char* base = reinterpret_cast<const char*>(q < per_mat ? w1 : w2);
        src = base + ((size_t)l * per_mat + q % per_mat) * C::SLAB_BYTES;
      }
      const uint32_t dst = smem_u32(ring + (s & 1) * C::SLAB_BYTES);
#pragma unroll
      for (int i = tid; i < C::SLAB_BYTES / 16; i += kThreads) cp_async16(dst + i * 16, src + i * 16);
    }
    cp_async_commit();  // an empty group keeps wait_group 1 meaning "slab s landed"
  };

  // acc += A[:, 64 ks : 64 ks + 64] x slab s (this warpgroup's columns), then s += 1.
  int s = 0;
  auto step = [&](const char* a_buf, int ks, float(&acc)[R]) {
    load_slab(s + 1);
    cp_async_wait1();
    fence_proxy_async();
    __syncthreads();  // slab s and the epilogues' activations are in place
    const uint32_t a0 = smem_u32(a_buf) + ks * (kSlabK / 8) * kActLbo;
    const uint32_t b0 = smem_u32(ring + (s & 1) * C::SLAB_BYTES) + wg * (C::NW / 8) * kSlabSbo;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kSlabK / 16; ++t)
      Mma<C::NW>::run(acc, make_desc(a0 + t * 2 * kActLbo, kActLbo, kActSbo),
                      make_desc(b0 + t * 2 * kSlabLbo, kSlabLbo, kSlabSbo));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();  // both warpgroups are done with stage s & 1
    ++s;
  };

  load_slab(0);

  // Positional encoding into act1 as 64 x 64: [x, sin(f0 x), cos(f0 x), ...]
  // with f_i = 2^i, column 63 zero; points past P encode the origin.
  for (int i = tid; i < kM * 32; i += kThreads) {
    const int m = i & (kM - 1), j0 = 2 * (i >> 6);
    const int64_t p = p0 + m;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + e;
      if (j < 3) {
        v[e] = p < P ? pts[p * 3 + j] : 0.0f;
      } else if (j < 63) {
        const int r = (j - 3) % 6, fi = (j - 3) / 6;
        const float x = p < P ? pts[p * 3 + (r % 3)] : 0.0f;
        const float xf = x * (float)(1 << fi);  // exact: power of two
        v[e] = r < 3 ? sinf(xf) : cosf(xf);
      } else {
        v[e] = 0.0f;
      }
    }
    act_store(act1, m, j0, v[0], v[1]);
  }

  float x[C::NPASS][R];
  float acc[R];
  float part[2] = {0.0f, 0.0f};

  // x = posenc @ w_in + b_in
#pragma unroll
  for (int j = 0; j < C::NPASS; ++j) {
    const int nb = j * C::NP + wg * C::NW;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    step(act1, 0, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) x[j][r] = acc[r] + __ldg(b_in + nb + frag_col(r, col0));
    if (L > 0) emit_act(x[j], nb, row0, col0, a1, c1, act0);
    else emit_out(x[j], nb, col0, a_out, c_out, w_out, part);
  }

  for (int l = 0; l < L; ++l) {
    const int lo = l * HP;
    // act1 = bf16(relu(a2 (act0 @ w1 + b1) + c2))
#pragma unroll
    for (int j = 0; j < C::NPASS; ++j) {
      const int nb = j * C::NP + wg * C::NW;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int ks = 0; ks < C::KS; ++ks) step(act0, ks, acc);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += __ldg(b1 + lo + nb + frag_col(r, col0));
      emit_act(acc, nb, row0, col0, a2 + lo, c2 + lo, act1);
    }
    // x = (x + act1 @ w2) + b2; then act0 for the next block, or the logit
#pragma unroll
    for (int j = 0; j < C::NPASS; ++j) {
      const int nb = j * C::NP + wg * C::NW;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int ks = 0; ks < C::KS; ++ks) step(act1, ks, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
        x[j][r] = __fadd_rn(__fadd_rn(x[j][r], acc[r]), __ldg(b2 + lo + nb + frag_col(r, col0)));
      if (l + 1 < L) emit_act(x[j], nb, row0, col0, a1 + lo + HP, c1 + lo + HP, act0);
      else emit_out(x[j], nb, col0, a_out, c_out, w_out, part);
    }
  }

  // Logit: sum the four threads of a row (quad), then the two warpgroups.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
  }
  if ((lane & 3) == 0) {
    red[wg * kM + row0] = part[0];
    red[wg * kM + row0 + 8] = part[1];
  }
  __syncthreads();
  if (tid < kM) {
    const int64_t p = p0 + tid;
    const float logit = (red[tid] + red[kM + tid]) + b_out;
    if (p < P) out[p] = (1.0f - 1.0f / (1.0f + expf(-logit))) * max_dist;
  }
}

template <int HP>
int launch(const void* pts, int64_t P, int L, const void* w_in, const void* b_in, const void* a1,
           const void* c1, const void* w1, const void* b1, const void* a2, const void* c2,
           const void* w2, const void* b2, const void* a_out, const void* c_out, const void* w_out,
           float b_out, float max_dist, void* out, void* stream) {
  const int smem = Cfg<HP>::SMEM;
  auto kern = folded_mlp_bf16_kernel<HP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (P + kM - 1) / kM;
  using B = __nv_bfloat16;
  kern<<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pts, P, L, (const B*)w_in, (const float*)b_in, (const float*)a1,
      (const float*)c1, (const B*)w1, (const float*)b1, (const float*)a2, (const float*)c2,
      (const B*)w2, (const float*)b2, (const float*)a_out, (const float*)c_out, (const B*)w_out,
      b_out, max_dist, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// H is the padded width (64, 128, 256 or 512); w_in, w1 and w2 are packed by
// ops/decoder_kernel.py `pack_kmajor`, w_out is (H,) bf16, the rest (padded)
// f32 vectors of H or (L, H).
extern "C" int surfd_folded_mlp_bf16(const void* pts, int64_t P, int H, int L, const void* w_in,
                                     const void* b_in, const void* a1, const void* c1,
                                     const void* w1, const void* b1, const void* a2,
                                     const void* c2, const void* w2, const void* b2,
                                     const void* a_out, const void* c_out, const void* w_out,
                                     float b_out, float max_dist, void* out, void* stream) {
  if (P <= 0) return 0;
  switch (H) {
#define SURFD_K1_CASE(HP)                                                                   \
  case HP:                                                                                  \
    return launch<HP>(pts, P, L, w_in, b_in, a1, c1, w1, b1, a2, c2, w2, b2, a_out, c_out, \
                      w_out, b_out, max_dist, out, stream);
    SURFD_K1_CASE(64)
    SURFD_K1_CASE(128)
    SURFD_K1_CASE(256)
    SURFD_K1_CASE(512)
#undef SURFD_K1_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
