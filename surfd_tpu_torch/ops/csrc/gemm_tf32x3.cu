// C = A B (+ bias) in float32 at f32 accuracy on Hopper's tensor cores, as
// 3xTF32 on wgmma: the AE decoder's 512 x 512 projections in train mode, in
// the three forms the step runs (ops/gemm_tf32x3.py `mm_tf32x3`):
//
//   NT  A row-major (K contiguous), B = W^T (K contiguous): X W^T, dG W^T
//   NN  A row-major, B row-major (N contiguous): G W, dY W
//   TN  A = X^T (M contiguous), B row-major: the weight gradients X^T dY,
//       whose K is the step's 160,000 query rows
//
// Replaces no TPU kernel: the JAX package left the decoder's matmuls to XLA
// (flax nn.Dense in surfd_tpu/models/decoder.py), and the port called cuBLAS
// in f32, which runs them on the FP32 pipe. The plain version is
// `mm_ref` in ops/gemm_tf32x3.py (torch.matmul).
//
// 3xTF32, as K1 f32 (folded_mlp.cu): each operand value a is split in
// registers into hi = tf32(a) and lo = tf32(a - hi) (round to nearest, ties
// away, masked to the 19 bits a tf32 keeps), and each product sums A_lo B_hi,
// A_hi B_lo and A_hi B_hi on the tensor cores; the dropped A_lo B_lo is about
// 2^-22 relative. The tensor cores' f32 sums truncate, so each k-block's
// products go into a fresh accumulator that is added to the running sum in
// f32 with round to nearest every kPromote k-blocks (K 128: 48 truncating
// steps a fresh sum); a K of 160,000 in one accumulator would drift by
// thousands of truncations. Single-pass TF32 is never used; the kernel does
// not read torch's allow_tf32.
//
// What bounds it on an H100. At 160,000 x 512 x 512 a GEMM is 83.9 GFLOP,
// three tf32 products each: 0.509 ms at 494.7 TFLOP/s dense TF32. The
// operands are 328 MB (the activation) and 1 MB (the weight), 0.1 ms at
// 3.35 TB/s, so the tensor cores bound it. What keeps it from them is the
// split: every operand value is split in registers by the same warps that
// issue the wgmmas (a warp that issues a group of them waits while they
// run), about 8,192 values a k-block, and B's halves go through shared
// memory. On an H100 80GB HBM3 at 700 W it runs at about 60 % of the bound
// (PERF.md's kernel table); the products alone, with the staging taken out,
// reach 70-90 %.
//
// Design (one CTA per 128 x 128 output tile and K chunk; 256 threads, two
// consumer warpgroups of 64 rows each, no producer warp):
// - A 4-stage ring of f32 k-blocks (32 deep) of A and B, loaded by TMA (one
//   thread issues, a barrier a stage counts the bytes in) as 128-byte
//   swizzled boxes in the operands' own layouts, so that the reads below
//   are free of bank conflicts and the ragged edges of M, N and K land as
//   zeros.
// - B is wgmma's shared-memory operand: each k-block the CTA splits it into
//   a hi and a lo plane, K-major core matrices without swizzle (tf32 wgmma
//   takes only K-major operands, so the N-contiguous B of NN and TN is
//   transposed here, on the way through registers). The planes are double
//   buffered.
// - A is wgmma's register operand: each thread loads its m64k8 fragments
//   from the ring and splits them in registers (double buffered across
//   k-blocks, since a fragment must live until its wgmma group is done).
// - A k-block's twelve m64n128k8 wgmmas (four k8 steps, three products) go
//   out in four commit groups, the staging of the next k-block (its TMA
//   issue, B's split, A's fragments) in between, so that the tensor cores
//   stay fed while the warps split.
// - Split-K: the TN form has only 16 output tiles at 512 x 512; the host
//   splits K over enough CTAs to fill the SMs (`plan` in gemm_tf32x3.py).
//   Each writes its partial tile to scratch; a second kernel sums the
//   partials in split order. No float atomics: two runs are bit-equal.
// - The bias (the forward's Conv1x1 bias) is added in the epilogue, or in
//   the reduction when K is split.
//
// Shared memory: the planes 2 x 2 x 16 KB, the ring 4 x 2 x 16 KB, the
// barriers and 1 KB to align the swizzled tiles: 197,664 bytes, one CTA per
// SM.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;  // output tile, k-block
constexpr int kThreads = 256;                  // two consumer warpgroups
constexpr int kStages = 4;                     // f32 k-blocks in the TMA ring
constexpr int kPromote = 4;                    // k-blocks summed in one fresh accumulator
constexpr int kTile = kBM * kBK;               // one operand's f32 k-block, floats (16 KB)
constexpr int kPlane = kBN * kBK;              // one tf32 plane of B, floats (16 KB)
static_assert(kBM == kBN, "A's and B's f32 tiles share their layouts");
// the planes (two buffers of hi and lo), the ring (A's and B's tiles a
// stage), a barrier a stage, and room to align the whole to 1 KB (the
// 128-byte swizzle's period)
constexpr int kSmemBytes = (4 * kPlane + kStages * 2 * kTile) * 4 + kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices adjacent in K) and stride byte offset
// (between core matrices adjacent in N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// A plane holds the k-block's 128 n x 32 k as core matrices of 8 n x 4 k (16
// bytes a row): k group k4 = k / 4 is a [n][4] block of 2 KB, so element
// (n, k) is at float 512 (k / 4) + 4 n + k % 4; LBO 2048 bytes, SBO 128.
constexpr uint32_t kPlaneLbo = kBN * 16, kPlaneSbo = 128;

// The f32 tiles as TMA leaves them: rows of 128 bytes (32 floats) whose
// 16-byte chunks are swizzled by the row's index mod 8. A K-contiguous
// operand's tile is 128 rows (m or n) of 32 k; an M- or N-contiguous one is
// four boxes of 32 k rows of 32 m or n. Float index of element (r, k), and
// of (k, m):
__device__ __forceinline__ int kmaj(int r, int k) {
  return r * 32 + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}
__device__ __forceinline__ int mnmaj(int k, int m) {
  return (m >> 5) * 1024 + k * 32 + (((((m & 31) >> 2) ^ k) & 7) << 2) + (m & 3);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// A 2-D box of `map` at (c0 innermost, c1) into shared memory at `dst`,
// completing on `bar`; out-of-range elements land as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// Make generic-proxy shared-memory writes (the planes) visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving accumulator reads or writes across a wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int r = 0; r < 64; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// tf32(a): round to nearest, ties away, keeping 10 mantissa bits, as
// cvt.rna.tf32.f32 and K1 f32 round, in two integer operations on the bit
// pattern (half of the 13 dropped bits' unit added, then those bits
// cleared): with cvt in their place each form ran about 11 % slower on an H100
// (PERF.md §6), the split of every operand value being on this kernel's
// critical path. A NaN operand still gives a NaN product (through lo); a
// magnitude that rounds past the largest float becomes infinite, as with cvt.
__device__ __forceinline__ uint32_t tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(__fsub_rn(a, __uint_as_float(hi)));
}

// D (64 x 128, f32, registers) = A (64 x 8, tf32, registers) * B (8 x 128,
// tf32, shared, K-major) + (scale_d ? D : 0). Register r of thread (warp w,
// lane) holds row 16 w + lane / 4 + 8 ((r / 2) % 2), column 8 (r / 4) +
// 2 (lane % 4) + r % 2; A register v holds row 16 w + lane / 4 + 8 (v % 2),
// column lane % 4 + 4 (v / 2).
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ta holds A: dims (K, M) where AK (K contiguous), else (M, K); tb holds
// B: (K, N) where BK, else (N, K); boxes of 32 x 128 (K-contiguous) or
// 32 x 32, 128-byte swizzle, zeros out of range. C is M x N row-major; with
// K split (gridDim.y > 1) each CTA writes its partial tile to
// c + blockIdx.y * M * N and bias is null; every chunk of K but the last is
// k_chunk long, a multiple of kBK * kPromote. vec: N a multiple of 4 and c
// 16-byte aligned (paired stores).
template <bool AK, bool BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const float* __restrict__ bias, float* __restrict__ c, int M, int N, int K,
                   int k_chunk, int tiles_n, int vec) {
  extern __shared__ __align__(1024) char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: align the tiles to it
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* planes = reinterpret_cast<float*>(smem);  // [buffer][hi, lo][kPlane]
  float* ring = planes + 4 * kPlane;                // [stage][A tile, B tile]
  const uint32_t bars = smem_u32(ring + kStages * 2 * kTile);  // a barrier a stage

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (blockIdx.x / tiles_n) * kBM, n0 = (blockIdx.x % tiles_n) * kBN;
  const int kbeg = blockIdx.y * k_chunk, kend = min(K, kbeg + k_chunk);
  // k-blocks, padded to whole promotion periods: only the last chunk of K
  // can end inside a period, and TMA loads what lies past K as zeros
  const int nk = (kend - kbeg + kBK * kPromote - 1) / (kBK * kPromote) * kPromote;
  const int r0 = 64 * wg + 16 * warp + g;  // this thread's first A row in the tile
  if (gridDim.y > 1) c += (int64_t)blockIdx.y * M * N;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // k-block s of this CTA's chunk into ring stage s % kStages by TMA, one
  // thread issuing; the stage's barrier completes when its 32 KB landed.
  auto load_stage = [&](int s) {
    if (tid == 0 && s < nk) {
      const int st = s % kStages, k = kbeg + s * kBK;
      const uint32_t as = smem_u32(ring + st * 2 * kTile), bs = as + kTile * 4;
      const uint32_t bar = bars + 8 * st;
      fence_proxy_async();  // the stage's earlier reads come before TMA's writes
      mbar_expect_tx(bar, 2 * kTile * 4);
      if (AK) {
        tma_load(as, &ta, k, m0, bar);
      } else {
#pragma unroll
        for (int i = 0; i < kBM / 32; ++i) tma_load(as + i * 4096, &ta, m0 + 32 * i, k, bar);
      }
      if (BK) {
        tma_load(bs, &tb, k, n0, bar);
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 32; ++i) tma_load(bs + i * 4096, &tb, n0 + 32 * i, k, bar);
      }
    }
  };
  auto wait_stage = [&](int s) { mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1); };

  // B's f32 tile -> its hi and lo planes: thread task (n, k4), four k each,
  // read as one 16-byte load (BK) or four loads down a column, written as
  // one 16-byte store per plane; a warp covers 32 consecutive n.
  auto split_b = [&](const float* bs, float* hi_plane, float* lo_plane, int i0, int i1) {
#pragma unroll
    for (int i = i0; i < i1; ++i) {
      const int q = tid + kThreads * i, n = q & (kBN - 1), k4 = q >> 7;
      float v[4];
      if (BK) {
        const float4 w = *reinterpret_cast<const float4*>(bs + kmaj(n, 4 * k4));
        v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = bs[mnmaj(4 * k4 + e, n)];
      }
      uint4 h, l;
      split(v[0], h.x, l.x);
      split(v[1], h.y, l.y);
      split(v[2], h.z, l.z);
      split(v[3], h.w, l.w);
      *reinterpret_cast<uint4*>(hi_plane + k4 * (4 * kBN) + 4 * n) = h;
      *reinterpret_cast<uint4*>(lo_plane + k4 * (4 * kBN) + 4 * n) = l;
    }
  };

  // This thread's A fragments of the k-block's four k8 steps, split.
  auto load_frags = [&](const float* as, uint32_t(&fh)[4][4], uint32_t(&fl)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 8 * j + t4;
      float v[4];
      if (AK) {
        v[0] = as[kmaj(r0, k)];
        v[1] = as[kmaj(r0 + 8, k)];
        v[2] = as[kmaj(r0, k + 4)];
        v[3] = as[kmaj(r0 + 8, k + 4)];
      } else {
        v[0] = as[mnmaj(k, r0)];
        v[1] = as[mnmaj(k, r0 + 8)];
        v[2] = as[mnmaj(k + 4, r0)];
        v[3] = as[mnmaj(k + 4, r0 + 8)];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], fh[j][e], fl[j][e]);
    }
  };

  float acc[64], tmp[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = tmp[r] = 0.0f;
  uint32_t fh0[4][4], fl0[4][4], fh1[4][4], fl1[4][4];  // fragments of even and odd k-blocks
  float* const pl0 = planes;               // even k-blocks' hi and lo planes
  float* const pl1 = planes + 2 * kPlane;  // odd ones'

  // The three products of k8 step j of a k-block as one commit group.
  auto products = [&](int j, const uint32_t(&fh)[4][4], const uint32_t(&fl)[4][4],
                      const float* pl, int fresh) {
    const uint64_t step = (uint64_t)(j * 2 * kPlaneLbo) >> 4;  // two k groups a k8 step
    const uint64_t dh = make_desc(smem_u32(pl), kPlaneLbo, kPlaneSbo) + step;
    const uint64_t dl = make_desc(smem_u32(pl + kPlane), kPlaneLbo, kPlaneSbo) + step;
    wgmma_fence();
    mma(tmp, fl[j], dh, fresh ? 0 : 1);  // A_lo B_hi
    mma(tmp, fh[j], dl, 1);              // A_hi B_lo
    mma(tmp, fh[j], dh, 1);              // A_hi B_hi
    wgmma_commit();
  };

  // k-block s: its four k8 steps' products (on the planes and fragments
  // of its parity) interleaved with the staging of k-block s + 1 into the
  // other parity's, so that the warps keep the tensor cores fed while they
  // split; then, at a period's end, the fresh sum is added to acc.
  auto block = [&](int s, const uint32_t(&fh)[4][4], const uint32_t(&fl)[4][4],
                   const float* pl, uint32_t(&nh)[4][4], uint32_t(&nl)[4][4], float* npl,
                   int fresh, int promote) {
    products(0, fh, fl, pl, fresh);
    wgmma_wait<1>();  // k-block s - 1's products are done: npl, nh, nl are free
    __syncthreads();  // everyone's; and ring stage s % kStages (k-block s) is read
    load_stage(s + kStages);
    if (s + 1 < nk) wait_stage(s + 1);  // past the last k-block nothing lands
    products(1, fh, fl, pl, 0);
    const float* as = ring + ((s + 1) % kStages) * 2 * kTile;
    split_b(as + kTile, npl, npl + kPlane, 0, 2);
    products(2, fh, fl, pl, 0);
    split_b(as + kTile, npl, npl + kPlane, 2, 4);
    fence_proxy_async();
    products(3, fh, fl, pl, 0);
    __syncthreads();  // the planes of k-block s + 1 are written
    load_frags(as, nh, nl);
    if (promote) {
      wgmma_wait<0>();
      fence_regs(tmp);
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = __fadd_rn(acc[r], tmp[r]);
    }
  };

  // k-blocks 0 .. kStages - 1 in flight, k-block 0 staged.
#pragma unroll
  for (int i = 0; i < kStages; ++i) load_stage(i);
  wait_stage(0);
  split_b(ring + kTile, pl0, pl0 + kPlane, 0, 4);
  fence_proxy_async();
  __syncthreads();
  load_frags(ring, fh0, fl0);
  // One promotion period: kPromote k-blocks, even ones on the first planes
  // and fragments, odd ones on the second.
  static_assert(kPromote % 2 == 0, "a period alternates the two buffers");
#pragma unroll 1
  for (int s = 0; s < nk; s += kPromote) {
#pragma unroll
    for (int q = 0; q < kPromote; q += 2) {
      block(s + q, fh0, fl0, pl0, fh1, fl1, pl1, q == 0, 0);
      block(s + q + 1, fh1, fl1, pl1, fh0, fl0, pl0, 0, q + 2 == kPromote);
    }
  }

  // Epilogue: register r holds row r0 + 8 ((r / 2) % 2), column
  // 8 (r / 4) + 2 t4 + r % 2 of the tile.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    float* row = c + (int64_t)m * N;
#pragma unroll
    for (int cg = 0; cg < 16; ++cg) {
      const int n = n0 + 8 * cg + 2 * t4;
      float v0 = acc[4 * cg + 2 * h], v1 = acc[4 * cg + 2 * h + 1];
      if (vec) {  // N is a multiple of 4: n + 1 < N where n < N
        if (n < N) {
          if (bias) v0 = __fadd_rn(v0, __ldg(bias + n)), v1 = __fadd_rn(v1, __ldg(bias + n + 1));
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        }
      } else {
        if (n < N) row[n] = bias ? __fadd_rn(v0, __ldg(bias + n)) : v0;
        if (n + 1 < N) row[n + 1] = bias ? __fadd_rn(v1, __ldg(bias + n + 1)) : v1;
      }
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... (+ bias[i % N]), in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ part, int splits, int64_t MN,
                                     int N, const float* __restrict__ bias,
                                     float* __restrict__ out, int vec) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (vec ? 4 : 1);
  if (i >= MN) return;
  if (vec) {  // MN and N multiples of 4: one row's four columns
    float4 s = *reinterpret_cast<const float4*>(part + i);
    for (int z = 1; z < splits; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(part + z * MN + i);
      s.x = __fadd_rn(s.x, p.x), s.y = __fadd_rn(s.y, p.y);
      s.z = __fadd_rn(s.z, p.z), s.w = __fadd_rn(s.w, p.w);
    }
    if (bias) {
      const int n = (int)(i % N);
      s.x = __fadd_rn(s.x, bias[n]), s.y = __fadd_rn(s.y, bias[n + 1]);
      s.z = __fadd_rn(s.z, bias[n + 2]), s.w = __fadd_rn(s.w, bias[n + 3]);
    }
    *reinterpret_cast<float4*>(out + i) = s;
  } else {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, part[z * MN + i]);
    if (bias) s = __fadd_rn(s, bias[i % N]);
    out[i] = s;
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The map of a 2-D f32 operand: `inner` contiguous elements a row, `outer`
// rows `ld` elements apart, boxes of 32 x `rows`, 128-byte swizzle.
int make_map(CUtensorMap* map, const void* p, int64_t inner, int64_t outer, int64_t ld, int rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                            reinterpret_cast<void**>(&encode), cudaEnableDefault,
                                            &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)rows}, unit[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p), dims, strides,
                      box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool AK, bool BK>
int launch(const void* a, int64_t lda, const void* b, int64_t ldb, const void* bias, void* c,
           void* part, int M, int N, int K, int k_chunk, int splits, int vec, cudaStream_t stream) {
  auto kern = gemm_tf32x3_kernel<AK, BK>;
  static bool sized = false;  // the shared-memory attribute, once per form
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  CUtensorMap ta, tb;
  int rc = AK ? make_map(&ta, a, K, M, lda, kBM) : make_map(&ta, a, M, K, lda, 32);
  if (!rc) rc = BK ? make_map(&tb, b, K, N, ldb, kBN) : make_map(&tb, b, N, K, ldb, 32);
  if (rc) return rc;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  using F = const float*;
  kern<<<dim3(tiles, splits), kThreads, kSmemBytes, stream>>>(
      ta, tb, splits > 1 ? nullptr : (F)bias, splits > 1 ? (float*)part : (float*)c, M, N, K,
      k_chunk, tiles_n, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t MN = (int64_t)M * N, threads = 256, per = vec ? 4 : 1;
  const int64_t blocks = (MN / per + threads - 1) / threads;
  splitk_reduce_kernel<<<(unsigned)blocks, threads, 0, stream>>>((F)part, splits, MN, N, (F)bias,
                                                                  (float*)c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// c (M x N, row-major) = a b (+ bias (N,)), f32. a_kmajor: a's K is its
// contiguous dimension (lda between rows), else its M; b_kmajor: b's K is
// contiguous (ldb between columns), else its N; lda and ldb multiples of 4,
// a and b 16-byte aligned (what TMA takes). The forms NT (1, 1), NN (1, 0)
// and TN (0, 0) are built; TT returns cudaErrorInvalidValue (the host copies
// b to row-major first). splits > 1 takes part, splits x M x N f32 scratch;
// every chunk but the last holds k_chunk (a multiple of 128) rows of K. vec
// as the kernel's.
extern "C" int surfd_gemm_tf32x3(const void* a, int64_t lda, int a_kmajor, const void* b,
                                 int64_t ldb, int b_kmajor, const void* bias, void* c, void* part,
                                 int M, int N, int K, int k_chunk, int splits, int vec,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || k_chunk <= 0 || k_chunk % (kBK * kPromote) ||
      lda % 4 || ldb % 4 || (uintptr_t)a % 16 || (uintptr_t)b % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  auto run = a_kmajor ? (b_kmajor ? launch<true, true> : launch<true, false>)
                      : (b_kmajor ? nullptr : launch<false, false>);
  if (!run) return (int)cudaErrorInvalidValue;
  return run(a, lda, b, ldb, bias, c, part, M, N, K, k_chunk, splits, vec, st);
}
