// Folded CBN-decoder MLP at float32 accuracy on Hopper's tensor cores, as
// 3xTF32 on wgmma: points (P, 3) -> UDF (P,).
//
// Replaces the TPU kernel `_decoder_kernel` / `pallas_folded_udf` of
// surfd_tpu/ops/decoder_kernel.py (retired in commit a9ab519) in the all-f32
// math of the live XLA function `folded_udf(dtype=float32)` there. The plain
// version is `folded_udf_ref` in ops/decoder_kernel.py, which also holds the
// host-side packing this kernel reads (`pack_afrag`). For one latent the
// conditional batch norms fold into affines, so the decoder is
//
//   x  = posenc(p) @ W_in + b_in                      posenc: f32, 3 -> 63
//   L times:  h = relu(a1*x + c1) @ W1 + b1
//             x = x + (relu(a2*h + c2) @ W2 + b2)
//   udf = (1 - sigmoid(relu(a_out*x + c_out) @ w_out + b_out)) * max_dist
//
// 3xTF32. Every matmul operand a is split into hi = tf32(a) and
// lo = tf32(a - hi), tf32 being round to nearest (ties away) to 10 mantissa
// bits (`cvt.rna.tf32.f32`, masked to the 19 bits a tf32 keeps), so
// |a - hi - lo| <= 2^-22 |a| or so. Each product sums W_lo*a_hi, W_hi*a_lo and
// W_hi*a_hi on the tensor cores; the dropped W_lo*a_lo is about 2^-22
// relative. A tf32 x tf32 product is exact in f32, and both halves are exact
// tf32 values, so whatever wgmma does with an operand's low 13 bits does not
// matter. The tensor cores' f32 sums do matter: they truncate. One running
// wgmma accumulator over K = 512 (192 truncating steps) read 9e-6 max abs
// against `folded_udf_ref` on the trained fixture (PERF.md §6), close to
// the 1e-5 bar. So each (16-row slab, M tile) sums its six products into a
// fresh accumulator, which is then added to the running sum in f32 with
// round to nearest (PERF.md §6 has both readings). The elementwise affines
// keep the f32 reference's roundings and associations: no contraction into
// FMA, and the residual as x + (acc + b2). The posenc uses full sinf/cosf
// (arguments up to 512 rad).
//
// What bounds it on an H100. At H = 512, L = 5 a point costs 2.654 M
// multiply-adds; three tf32 products each are 3 x 5.566 TFLOP at 2^20 points,
// 33.7 ms at 494.7 TFLOP/s. But every 32-point CTA streams all 10.62 MB of f32
// weights (they stay in the 50 MB L2): 348 GB at 2^20 points, about 75 ms at
// the effective 4.6 TB/s K1 bf16 reaches on its own weight bytes (PERF.md).
// So the weight stream is the bound this design can meet; streaming f32 once
// and splitting on the SM keeps it at half of what pre-split hi and lo
// weights would cost. On an H100 80GB HBM3 at 700 W it takes 107 ms, an
// effective 3.25 TB/s for those assumed bytes (PERF.md §6), and a deeper
// ring does not move it: each warpgroup's chain of shared loads, splits, one
// wgmma group and its wait is the suspect. A 64-point tile or a cluster
// sharing each slab would halve the stream (not done here).
//
// Design: A and B swapped against K1 bf16. Each matmul computes
// D^T = W^T act^T: the hidden units are wgmma's M, a CTA's 32 points its N.
// - One CTA per 32 points, two consumer warpgroups (one at H = 64); each owns
//   H / 128 of the H / 64 M tiles of 64 hidden units.
// - Activations are B, in shared memory, K-major ([point][k] core matrices,
//   no swizzle), as a hi plane and a lo plane: the posenc, then each block's
//   relu(a1*x + c1), then its relu(a2*h + c2), in turn. W1's output stays in
//   registers until both warpgroups have read the planes, so one pair serves.
// - Weights are A, from registers: f32 slabs of 16 K rows x H columns stream
//   from L2 through a 2-stage cp.async ring. The host packs them in A-fragment
//   order, so a thread reads its fragment of one (M tile, k8 step) with one
//   16-byte shared load, then splits it into hi and lo in registers.
// - Per slab and M tile a warpgroup issues one group of six m64n32k8 tf32
//   wgmmas (two k8 steps, three products) into a fresh accumulator; the next
//   tile's fragments load and split while it runs.
// - The f32 residual x lives in registers in the accumulator layout (64 per
//   thread at H = 512), beside the running sum (64), the group accumulator
//   (16) and two fragment sets (32).
// - Output head: per thread relu(a_out*x + c_out) * w_out over its rows, a
//   shuffle sum over the 8 lanes that hold the same points, one sum across
//   the warps in shared memory, then (1 - sigmoid) * max_dist.
// The hidden width is padded on the host to 64, 128, 256 or 512 with zero
// weights, biases and affines, which keep the padded units exactly 0.
//
// Shared memory at H = 512: ring 2 x 32 KB, activation planes 2 x 64 KB,
// 1 KB for the cross-warp sum: 197,632 bytes, one CTA per SM. ptxas: 198
// registers, no spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 32;       // points per CTA: the wgmma N
constexpr int kSlabK = 16;   // K rows of one streamed weight slab: two k8 steps
constexpr int kStages = 2;   // slabs in the cp.async ring (a third was no faster)
constexpr int kPosK = 64;    // posenc rows: 63 and a zero row

template <int HP>
struct Cfg {
  static constexpr int WG = HP >= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int THREADS = 128 * WG;
  static constexpr int MTILES = HP / 64;
  static constexpr int MT = MTILES / WG;        // M tiles per warpgroup
  static constexpr int KS = HP / kSlabK;        // slabs per H x H matrix
  static constexpr int SLAB_BYTES = kSlabK * HP * 4;
  static constexpr int PLANE_BYTES = kN * HP * 4;
  static constexpr int SMEM = kStages * SLAB_BYTES + 2 * PLANE_BYTES + 4 * WG * kN * 4;
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

// An activation plane holds 32 points x K f32 (K-major B operand) as core
// matrices of 8 points x 4 k (16 bytes) ordered [k / 4][n / 8]: LBO = 4 * 128
// bytes, SBO = 128 bytes; K row k starts at byte 128 k.
constexpr uint32_t kActLbo = 4 * 128, kActSbo = 128;
__device__ __forceinline__ int act_off(int n, int k) {
  return (k >> 2) * kActLbo + (n >> 3) * kActSbo + (n & 7) * 16 + (k & 3) * 4;
}

// The m64nNk8 f32 accumulator: register r of thread (warp w, lane) holds row
// 16 w + lane / 4 + 8 ((r / 2) % 2) and column 2 (lane % 4) + 8 (r / 4) + r % 2.
// row0 = 16 w + lane / 4, col0 = 2 (lane % 4). Here rows are hidden units
// (`unit` in the kernel) and columns points.
__device__ __forceinline__ int frag_col(int r, int col0) { return col0 + 8 * (r >> 2) + (r & 1); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// Make generic-proxy shared-memory writes visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving accumulator reads or writes across a wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// tf32(a): round to nearest, ties away, keeping 10 mantissa bits; the mask
// makes the low 13 bits 0 whatever cvt leaves there.
__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(__fsub_rn(a, __uint_as_float(hi)));
}

// D (64 x 32, f32, registers) = A (64 x 8, tf32, registers) * B (8 x 32,
// tf32, shared, stored 32 x 8 K-major) + (scale_d ? D : 0).
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ float affine_relu(float x, float a, float c) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), c), 0.0f);
}

template <int HP>
__global__ void __launch_bounds__(Cfg<HP>::THREADS, 1)
folded_mlp_tf32x3_kernel(const float* __restrict__ pts, int64_t P, int L,
                         const float* __restrict__ w_in, const float* __restrict__ b_in,
                         const float* __restrict__ a1, const float* __restrict__ c1,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ a2, const float* __restrict__ c2,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ a_out, const float* __restrict__ c_out,
                         const float* __restrict__ w_out, float b_out, float max_dist,
                         float* __restrict__ out) {
  using C = Cfg<HP>;
  constexpr int MT = C::MT;
  extern __shared__ __align__(128) char smem[];
  char* ring = smem;  // kStages slabs
  char* act_hi = smem + kStages * C::SLAB_BYTES;
  char* act_lo = act_hi + C::PLANE_BYTES;
  float* red = reinterpret_cast<float*>(act_lo + C::PLANE_BYTES);  // [warp][point]

  const int tid = threadIdx.x, wg = tid >> 7, tt = tid & 127, warp = tt >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int64_t p0 = (int64_t)blockIdx.x * kN;
  // hidden unit of this thread's registers 2h, 2h + 1 (+4, +8, +12) of M tile i
  auto unit = [&](int i, int h) { return (wg * MT + i) * 64 + row0 + 8 * h; };

  // The slab stream: w_in (kPosK / kSlabK slabs), then per block w1 and w2
  // (KS slabs each); each matrix is packed slab after slab.
  constexpr int kInSlabs = kPosK / kSlabK;
  const int total = kInSlabs + 2 * L * C::KS;
  auto load_slab = [&](int s) {
    if (s < total) {
      const char* src;
      if (s < kInSlabs) {
        src = reinterpret_cast<const char*>(w_in) + (size_t)s * C::SLAB_BYTES;
      } else {
        const int u = s - kInSlabs, l = u / (2 * C::KS), q = u % (2 * C::KS);
        const char* base = reinterpret_cast<const char*>(q < C::KS ? w1 : w2);
        src = base + ((size_t)l * C::KS + q % C::KS) * C::SLAB_BYTES;
      }
      const uint32_t dst = smem_u32(ring + (s % kStages) * C::SLAB_BYTES);
#pragma unroll
      for (int i = tid; i < C::SLAB_BYTES / 16; i += C::THREADS) cp_async16(dst + i * 16, src + i * 16);
    }
    cp_async_commit();  // an empty group keeps wait_group counting slabs
  };

  // acc += activations[:, kb : kb + 16] x slab s (this warpgroup's M tiles),
  // s += 1. Each (slab, M tile) is one wgmma group of six products that sums
  // into a fresh tmp, added to acc in f32 (round to nearest) once the group
  // is done: the tensor cores' own sums truncate, and a group's six steps
  // truncate relative to one slab's partial, not to the running sum. While a
  // group runs, the next tile's fragments load and split into the other
  // fragment set. (Reading a finished group's tmp while the next group runs
  // makes ptxas serialize every wgmma, so each group is waited for.)
  int s = 0;
  float acc[MT][16], tmp[16];
  // hi / lo of this thread's A fragments of M tile i, both k8 steps of a slab
  auto load_frag = [&](const char* slab, int i, uint32_t(&hi)[2][4], uint32_t(&lo)[2][4]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(
          slab + ((q * C::MTILES + wg * MT + i) * 128 + tt) * 16);
      split(w.x, hi[q][0], lo[q][0]);
      split(w.y, hi[q][1], lo[q][1]);
      split(w.z, hi[q][2], lo[q][2]);
      split(w.w, hi[q][3], lo[q][3]);
    }
  };
  auto step = [&](int kb) {
    cp_async_wait<kStages - 2>();  // slab s has landed (this thread's copies)
    fence_proxy_async();           // the epilogues' plane writes, for wgmma
    __syncthreads();               // everyone's copies; stage (s - 1) is free
    load_slab(s + kStages - 1);
    const char* slab = ring + (s % kStages) * C::SLAB_BYTES;
    uint64_t b_hi[2], b_lo[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t k_off = (uint32_t)(kb + 8 * q) * 128;
      b_hi[q] = make_desc(smem_u32(act_hi) + k_off, kActLbo, kActSbo);
      b_lo[q] = make_desc(smem_u32(act_lo) + k_off, kActLbo, kActSbo);
    }
    uint32_t hi[2][2][4], lo[2][2][4];  // two fragment sets
    load_frag(slab, 0, hi[0], lo[0]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int f = i & 1;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        mma(tmp, lo[f][q], b_hi[q], q);  // W_lo a_hi; the group's first starts from 0
        mma(tmp, hi[f][q], b_lo[q], 1);  // W_hi a_lo
        mma(tmp, hi[f][q], b_hi[q], 1);  // W_hi a_hi
      }
      wgmma_commit();
      if (i + 1 < MT) load_frag(slab, i + 1, hi[f ^ 1], lo[f ^ 1]);
      wgmma_wait<0>();
      fence_regs(tmp);
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[i][r] = __fadd_rn(acc[i][r], tmp[r]);
    }
    ++s;
  };
  // acc = activations[:, :K] x the next K / 16 slabs; then every warpgroup is
  // done reading the planes.
  auto matmul = [&](int K) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[i][r] = 0.0f;
    for (int kb = 0; kb < K; kb += kSlabK) step(kb);
    __syncthreads();
  };
  // planes[point][unit] = hi / lo of relu(a * v + c) over this thread's fragment
  auto emit_act = [&](const float(&v)[MT][16], const float* __restrict__ a,
                      const float* __restrict__ c) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = unit(i, h);
        const float av = __ldg(a + m), cv = __ldg(c + m);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = 4 * (j >> 1) + 2 * h + (j & 1);
          uint32_t hv, lv;
          split(affine_relu(v[i][r], av, cv), hv, lv);
          const int off = act_off(frag_col(r, col0), m);
          *reinterpret_cast<uint32_t*>(act_hi + off) = hv;
          *reinterpret_cast<uint32_t*>(act_lo + off) = lv;
        }
      }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_slab(i);

  // Positional encoding, K rows 0..63: [x, sin(f0 x), cos(f0 x), ...] with
  // f_i = 2^i, row 63 zero; points past P encode the origin.
  for (int i = tid; i < kPosK * kN; i += C::THREADS) {
    const int n = i & (kN - 1), j = i / kN;
    const int64_t p = p0 + n;
    float v = 0.0f;
    if (j < 3) {
      v = p < P ? pts[p * 3 + j] : 0.0f;
    } else if (j < 63) {
      const int r = (j - 3) % 6, fi = (j - 3) / 6;
      const float x = p < P ? pts[p * 3 + (r % 3)] : 0.0f;
      const float xf = x * (float)(1 << fi);  // exact: power of two
      v = r < 3 ? sinf(xf) : cosf(xf);
    }
    uint32_t hv, lv;
    split(v, hv, lv);
    *reinterpret_cast<uint32_t*>(act_hi + act_off(n, j)) = hv;
    *reinterpret_cast<uint32_t*>(act_lo + act_off(n, j)) = lv;
  }

  float x[MT][16];

  // x = posenc @ w_in + b_in
  matmul(kPosK);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 16; ++r) x[i][r] = __fadd_rn(acc[i][r], __ldg(b_in + unit(i, (r >> 1) & 1)));
  if (L > 0) emit_act(x, a1, c1);

  for (int l = 0; l < L; ++l) {
    const int lo = l * HP;
    // planes = relu(a2 (planes @ w1 + b1) + c2)
    matmul(HP);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[i][r] = __fadd_rn(acc[i][r], __ldg(b1 + lo + unit(i, (r >> 1) & 1)));
    emit_act(acc, a2 + lo, c2 + lo);
    // x = x + (planes @ w2 + b2); then the next block's planes
    matmul(HP);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 16; ++r)
        x[i][r] = __fadd_rn(x[i][r], __fadd_rn(acc[i][r], __ldg(b2 + lo + unit(i, (r >> 1) & 1))));
    if (l + 1 < L) emit_act(x, a1 + lo + HP, c1 + lo + HP);
  }

  // Logit: this thread's points col0 + 8 c + e (part[2 c + e]) summed over
  // its units, then over the 8 lanes that share the points, then the warps.
  float part[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) part[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int m = unit(i, (r >> 1) & 1);
      const int j = 2 * (r >> 2) + (r & 1);
      part[j] = fmaf(affine_relu(x[i][r], __ldg(a_out + m), __ldg(c_out + m)), __ldg(w_out + m), part[j]);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 4);
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 8);
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(tid >> 5) * kN + col0 + 8 * (j >> 1) + (j & 1)] = part[j];
  }
  __syncthreads();
  if (tid < kN) {
    float logit = 0.0f;
#pragma unroll
    for (int w = 0; w < 4 * C::WG; ++w) logit += red[w * kN + tid];
    logit += b_out;
    const int64_t p = p0 + tid;
    if (p < P) out[p] = (1.0f - 1.0f / (1.0f + expf(-logit))) * max_dist;
  }
}

template <int HP>
int launch(const void* pts, int64_t P, int L, const void* w_in, const void* b_in, const void* a1,
           const void* c1, const void* w1, const void* b1, const void* a2, const void* c2,
           const void* w2, const void* b2, const void* a_out, const void* c_out, const void* w_out,
           float b_out, float max_dist, void* out, void* stream) {
  using C = Cfg<HP>;
  auto kern = folded_mlp_tf32x3_kernel<HP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (P + kN - 1) / kN;
  using F = const float*;
  kern<<<(unsigned)tiles, C::THREADS, C::SMEM, (cudaStream_t)stream>>>(
      (F)pts, P, L, (F)w_in, (F)b_in, (F)a1, (F)c1, (F)w1, (F)b1, (F)a2, (F)c2, (F)w2, (F)b2,
      (F)a_out, (F)c_out, (F)w_out, b_out, max_dist, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// H is the padded width (64, 128, 256 or 512); w_in, w1 and w2 are packed by
// ops/decoder_kernel.py `pack_afrag` (w_in with a zero 64th row), w_out is
// (H,) f32, the rest (padded) f32 vectors of H or (L, H).
extern "C" int surfd_folded_mlp_f32(const void* pts, int64_t P, int H, int L, const void* w_in,
                                    const void* b_in, const void* a1, const void* c1,
                                    const void* w1, const void* b1, const void* a2, const void* c2,
                                    const void* w2, const void* b2, const void* a_out,
                                    const void* c_out, const void* w_out, float b_out,
                                    float max_dist, void* out, void* stream) {
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
