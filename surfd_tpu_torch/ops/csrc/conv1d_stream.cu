// Forward 1-D convolution of the denoiser's UNet1D in f32, as a
// weight-streaming split-K matrix product:
//   out[b, co, t] = bias[co] + sum_{ci, k} W[co, ci, k] * x[b, ci, t*s + k - p].
//
// It replaces no TPU kernel: the JAX package left these convolutions to XLA
// (flax's nn.Conv in surfd_tpu/models/unet1d.py), and the port ran them
// through cuDNN (F.conv1d), whose implicit GEMM tiles for large products and
// gives an 8- to 64-column product a handful of CTAs, each walking a K of
// thousands serially while most SMs sit idle.
//
// What bounds it on an H100: reading the weights. One denoiser call at B 2,
// latent 32 runs 98 convolutions with 124.0 M f32 weights (496 MB) and 4.04
// GFLOP: 8 FLOP a byte, under FP32's ridge of ~20 (67 TFLOP/s over 3.35 TB/s).
// The call's floor is 0.148 ms of HBM reads; a single 896->896 k3 conv (9.6
// MB) has 2.9 us of it. The product is W (Cout x Cin*K, the module's own
// weight read in place, row-major) times the im2col of x (Cin*K x M, M = B *
// L_out, 8 to 64 columns at B 2, up to 256 on the text path at B 4).
//
// Design, aimed at streaming W once with the whole card:
// - The split. A CTA of 8 warps owns `wr` x 4 weight rows and a k-range of
//   W; its warps split the rows (wr of them) and the k-range (8 / wr); a
//   thread-block cluster of S CTAs (S <= 8, grid.x) splits W's columns
//   further; grid.y walks the row tiles, grid.z the column tiles of 64 past
//   M 64. The wrapper picks (wr, S) from the conv's shape alone
//   (ops/conv1d_kernel.py `plan`, set from a sweep on the card): all warps
//   on rows where the grid still has ~100 CTAs, as many CTAs along k as keep
//   it within ~200; no knob.
// - The stream. A warp steps through its k-range 4 * LK columns of W at a
//   time for 4 rows: lane (lk, lm) holds W[row, k + 4 lk .. +3] of each row in
//   registers, read by 16-byte non-caching loads, so that a warp's load is
//   a run of whole 128-byte lines; two steps are in flight while it
//   computes (a register double buffer; four, tried at 8 columns, read
//   slower). The weights go straight from HBM to registers: no copy of
//   them is made, before or during the call.
// - Im2col in shared memory only. Each CTA stages the im2col of its
//   k-range and column tile, [MT][kc] with k contiguous, after its first
//   weight loads are issued: it reads the slice of x that the tile uses
//   (its channels of each batch, contiguous runs) once, in x's order, and
//   writes each element to the K slots that use it by index arithmetic
//   (stride 1 or 2, padding, batch edges; the rest stays zero). Gathering
//   the im2col from x directly cost up to 5 us a conv: 4-byte reads that
//   use a few bytes of each L2 sector. A lane reads its 4 k of a
//   column as one 16-byte load: a quarter-warp reads 128 contiguous bytes,
//   free of bank conflicts. Each such read feeds 16 FFMA (4 rows x 4 k), as
//   many as the FP32 pipe takes per shared-memory wavefront.
// - The sums, all f32 FFMA in a fixed order. A lane sums its k in order
//   into 4 x TM accumulators (TM 8 or 16 columns; LM lanes split the columns
//   past 16); the LK lanes of a column group are reduced by a butterfly
//   reduce-scatter of shuffles (the CTA's warps along k, where there are
//   several, summed in order in shared memory); output e of the tile
//   belongs to the cluster's rank e % S, and every CTA stores its partial
//   of e into that rank's shared memory over DSMEM; after one
//   `cluster.sync()` each CTA sums its outputs' partials in rank order from
//   its own shared memory, adds the bias (then the residual, where the
//   caller fuses one: the block's skip path) and writes (B, Cout, L_out). No
//   atomics and no workspace: two calls give the same bits, one launch per
//   conv, nothing to reset between CUDA-graph replays.
// - The fixed cost of a launch is most of a small conv's time, so nothing
//   on that path waits twice: the column and bias tables are made once per
//   CTA (the only divisions by a runtime value), the im2col is staged by
//   additions with a thread's loads in flight together, the cluster's
//   partials are pushed, not pulled, so one cluster barrier closes the
//   reduction and no CTA waits for its peers before it exits (the arrival
//   that shows every CTA has started is made at the top, waited on late).
// - M past 64 is tiled over grid.z: each column tile streams W again (from
//   L2 for the text path's small-weight levels).
// - Templates: K (1 or 3), whether W's rows are 16-byte aligned (else scalar
//   loads: the 1-channel input conv), and the column layout (TM, LM):
//   (8, 1) for M <= 8, (16, 1) <= 16, (16, 2) <= 32, (16, 4) above.
// - The kernel is launched only by the entry point below, always with its
//   cluster; it checks the cluster's size and traps first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 4;           // weight rows a warp owns
constexpr int kMaxSplits = 8;    // the portable cluster size
// A CTA's most shared memory is 227 KB (232,448 bytes); 1 KB of it is kept for
// the static column and bias tables.
constexpr int kMaxSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* x;     // (B, Cin, Lin), contiguous
  const float* w;     // (Cout, Cin, K), contiguous: (Cout, Kw) row-major
  const float* bias;  // (Cout,) or null
  const float* res;   // (B, Cout, Lout), contiguous, added to the output; or null
  float* out;         // (B, Cout, Lout), contiguous
  int Cin, Lin, Cout, Lout, stride, pad;
  int M, Kw;          // B * Lout, Cin * K
  int wr;             // warps along rows; 8 / wr along k
  int kc;             // a CTA's k-range (a multiple of the warp step); the staged tile's row stride
};

__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// W[row0 + r, kg .. kg + 3] for the warp's 4 rows, zero past Cout or k1.
template <bool VEC>
__device__ __forceinline__ void load_w(const float* w, int Kw, int Cout, int row0, int kg, int k1,
                                       float4 (&wv)[kTR]) {
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int row = row0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < Cout && kg < k1) {
      const float* src = w + (size_t)row * Kw + kg;
      if constexpr (VEC) {
        v = ld_stream(src);  // Kw % 4 == 0 and k1 too: never past k1
      } else {
        v.x = __ldg(src);
        if (kg + 1 < k1) v.y = __ldg(src + 1);
        if (kg + 2 < k1) v.z = __ldg(src + 2);
        if (kg + 3 < k1) v.w = __ldg(src + 3);
      }
    }
    wv[r] = v;
  }
}

// acc[r][j] += sum over the lane's 4 k of W[r, k] * X[k, j]; xs points at the
// lane's first column row, at its k.
template <int TM>
__device__ __forceinline__ void mac(const float* xs, int ldx, const float4 (&wv)[kTR],
                                    float (&acc)[kTR][TM]) {
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + j * ldx);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      acc[r][j] = fmaf(wv[r].x, xv.x, acc[r][j]);
      acc[r][j] = fmaf(wv[r].y, xv.y, acc[r][j]);
      acc[r][j] = fmaf(wv[r].z, xv.z, acc[r][j]);
      acc[r][j] = fmaf(wv[r].w, xv.w, acc[r][j]);
    }
  }
}

// Level LVL of a butterfly reduce-scatter of v[0, NV >> LVL) over the LK =
// 2^LOG_LK lanes of a column group: the lanes with bit o set keep the upper
// half, each half summed with the partner's. After the last level lane lk
// holds the sums of v[lk * PER .. lk * PER + PER - 1], PER = NV / LK. The
// recursion keeps every index a constant, so v stays in registers.
template <int LVL, int LOG_LK, int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane) {
  if constexpr (LVL < LOG_LK) {
    constexpr int o = (1 << LOG_LK) >> (LVL + 1), half = NV >> (LVL + 1);
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
    reduce_scatter<LVL + 1, LOG_LK, NV>(v, lane);
  }
}

template <int K, bool VEC, int TM, int LM>
__global__ void __launch_bounds__(kThreads, 2) conv1d_stream_kernel(const Params p) {
  constexpr int LK = 32 / LM;       // lanes along k
  constexpr int KSTEP = 4 * LK;     // k of a warp step
  constexpr int MT = TM * LM;       // columns of a CTA
  constexpr int NV = kTR * TM;      // accumulators of a lane
  constexpr int PER = NV / LK;      // sums a lane keeps after the reduce-scatter
  constexpr int LOG_LK = LK == 32 ? 5 : LK == 16 ? 4 : 3;
  static_assert(NV % LK == 0 && PER >= 1 && (1 << LOG_LK) == LK, "column layout");
  extern __shared__ __align__(16) float sm[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;
  if (cluster.num_blocks() != (unsigned)S) __trap();  // launched without its cluster
  const int rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwk = kWarps / p.wr, wrow = warp % p.wr, wk = warp / p.wr;
  const int rows = p.wr * kTR;
  const int tile_row0 = blockIdx.y * rows, row0 = tile_row0 + wrow * kTR;
  const int m0 = blockIdx.z * MT;
  const int k0 = rank * p.kc, k1 = min(p.Kw, k0 + p.kc);
  const int lk = lane % LK, lm = lane / LK;
  const int nsteps = max(0, (k1 - k0 + KSTEP - 1) / KSTEP);
  const int s_beg = nsteps * wk / nwk, s_end = nsteps * (wk + 1) / nwk;
  float* xs = sm;                    // [MT][kc]: the im2col of the tile, k contiguous
  float* part = xs + MT * p.kc;      // [nwk][rows][MT]: the warps' partials, with nwk > 1
  float* recv = part + (nwk > 1 ? nwk * rows * MT : 0);  // [S][per_rank]: the cluster's partials
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");  // this CTA has started
  __shared__ int col_o[MT];          // a column's offset in out, less the row's
  __shared__ float bias_s[kWarps * kTR];

  // The first two steps' weights go out before anything waits.
  float4 wa[kTR], wb[kTR];
  const int kl = 4 * lk;  // the lane's offset in a step
  if (s_beg < s_end) load_w<VEC>(p.w, p.Kw, p.Cout, row0, k0 + s_beg * KSTEP + kl, k1, wa);
  if (s_beg + 1 < s_end) load_w<VEC>(p.w, p.Kw, p.Cout, row0, k0 + (s_beg + 1) * KSTEP + kl, k1, wb);

  // The column and bias tables, once; the tile zeroed (padding, the columns
  // past M, the k past k1 stay zero).
  if (tid < MT) {
    const int mg = m0 + tid, b = mg / p.Lout;
    col_o[tid] = b * p.Cout * p.Lout + mg - b * p.Lout;
  } else if (tid - MT < rows) {
    const int row = tile_row0 + tid - MT;
    bias_s[tid - MT] = p.bias != nullptr && row < p.Cout ? __ldg(p.bias + row) : 0.0f;
  }
  for (int i = tid; i < MT * p.kc / 4; i += kThreads)
    reinterpret_cast<float4*>(xs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // Stage the im2col of columns [m0, m0 + MT) and k [k0, k1) from x's slice
  // that it reads: channels [c0, c1) of each batch the columns touch, rows
  // of L_in read in x's order (a warp's loads on consecutive addresses, each
  // element once, all of a thread's in flight together) and written to each
  // (column, k) slot that uses it, K of them at stride 1. Indices step by
  // additions.
  {
    const int c0 = k0 / K, nch = (k1 - 1) / K + 1 - c0, klen = k1 - k0;
    const int b0 = m0 / p.Lout, nb = (min(p.M, m0 + MT) - 1) / p.Lout + 1 - b0;
    const int dr = kThreads / p.Lin, dpos = kThreads - dr * p.Lin;
    int pos = tid % p.Lin, c = tid / p.Lin, bi = c / nch;
    c -= bi * nch;
#pragma unroll 8
    for (int e = tid; e < nb * nch * p.Lin; e += kThreads) {
      const float v = __ldg(p.x + ((size_t)(b0 + bi) * p.Cin + c0 + c) * p.Lin + pos);
      const int mb = (b0 + bi) * p.Lout - m0, kb = (c0 + c) * K - k0;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int ts = pos + p.pad - kk;  // t * stride
        const int t = p.stride == 1 ? ts : ts >> 1;
        const unsigned m = mb + t, k = kb + kk;
        if (ts >= 0 && (p.stride == 1 || !(ts & 1)) && t < p.Lout && m < MT && k < (unsigned)klen)
          xs[m * p.kc + k] = v;
      }
      pos += dpos;
      c += dr;
      if (pos >= p.Lin) {
        pos -= p.Lin;
        ++c;
      }
      while (c >= nch) {
        c -= nch;
        ++bi;
      }
    }
  }
  __syncthreads();

  float acc[kTR][TM];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[r][j] = 0.0f;
  const float* xl = xs + lm * TM * p.kc + kl;
  for (int s = s_beg; s < s_end; s += 2) {
    mac<TM>(xl + s * KSTEP, p.kc, wa, acc);
    if (s + 2 < s_end) load_w<VEC>(p.w, p.Kw, p.Cout, row0, k0 + (s + 2) * KSTEP + kl, k1, wa);
    if (s + 1 < s_end) {
      mac<TM>(xl + (s + 1) * KSTEP, p.kc, wb, acc);
      if (s + 3 < s_end) load_w<VEC>(p.w, p.Kw, p.Cout, row0, k0 + (s + 3) * KSTEP + kl, k1, wb);
    }
  }

  // The LK lanes of the column group: a butterfly reduce-scatter.
  float v[NV];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int j = 0; j < TM; ++j) v[r * TM + j] = acc[r][j];
  reduce_scatter<0, LOG_LK, NV>(v, lane);

  // Output e of the tile is summed by rank e % S: every CTA stores its
  // partial of e into that rank's `recv`, row `rank`, slot e / S (the CTA's
  // warps along k summed in order first). Every CTA of the cluster has
  // started (the arrival at the top), so its shared memory takes the stores.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int tile = rows * MT, per_rank = (tile + S - 1) / S;
  if (nwk == 1) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = lk * PER + q, r = i / TM, j = i - r * TM;
      const int e = (wrow * kTR + r) * MT + lm * TM + j, slot = e / S;
      cluster.map_shared_rank(recv, e - slot * S)[rank * per_rank + slot] = v[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = lk * PER + q, r = i / TM, j = i - r * TM;
      part[(wk * rows + wrow * kTR + r) * MT + lm * TM + j] = v[q];
    }
    __syncthreads();
    for (int e = tid; e < tile; e += kThreads) {
      float sum = part[e];
      for (int w = 1; w < nwk; ++w) sum += part[w * tile + e];
      const int slot = e / S;
      cluster.map_shared_rank(recv, e - slot * S)[rank * per_rank + slot] = sum;
    }
  }

  // This CTA's outputs e = rank + S * j: the cluster's partials summed in
  // rank order from its own shared memory; no CTA reads a peer's after this.
  cluster.sync();
  for (int j = tid; j < per_rank; j += kThreads) {
    const int e = rank + S * j, rl = e / MT, ml = e - rl * MT, row = tile_row0 + rl;
    if (e >= tile || row >= p.Cout || m0 + ml >= p.M) continue;
    float got[kMaxSplits];
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src)
      if (src < S) got[src] = recv[src * per_rank + j];
    float sum = got[0];
#pragma unroll
    for (int src = 1; src < kMaxSplits; ++src)
      if (src < S) sum += got[src];
    const size_t o = col_o[ml] + (size_t)row * p.Lout;
    const float y = sum + bias_s[rl];
    p.out[o] = p.res != nullptr ? y + __ldg(p.res + o) : y;
  }
}

template <int K, bool VEC, int TM, int LM>
cudaError_t launch(const Params& p, int splits, cudaStream_t stream) {
  constexpr int MT = TM * LM;
  const int rows = p.wr * kTR, tile = rows * MT;
  const size_t smem = ((size_t)MT * p.kc + (p.wr < kWarps ? (size_t)(kWarps / p.wr) * tile : 0) +
                       (size_t)splits * ((tile + splits - 1) / splits)) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = conv1d_stream_kernel<K, VEC, TM, LM>;
  // The opt-in above 48 KB is a CUDA API call: made once per device and
  // instantiation, at the largest size, not on every launch.
  static unsigned long long opted_in = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(opted_in >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (p.Cout + rows - 1) / rows, (p.M + MT - 1) / MT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// x (B, Cin, Lin), w (Cout, Cin, K), bias (Cout,) or null, res (B, Cout,
// Lout) or null, out (B, Cout, Lout), all contiguous f32 on the current
// device; out = conv(x) + bias, then + res. The split (tm, lm, wr,
// splits, kc) is the wrapper's plan for the shape; vec: w's rows are 16-byte
// aligned. Returns the launch's cudaError_t (a refused argument or cluster
// launch included).
extern "C" int surfd_conv1d_stream(const void* x, const void* w, const void* bias,
                                   const void* res, void* out, int B, int Cin, int Lin, int Cout,
                                   int Lout, int K,
                                   int stride, int pad, int tm, int lm, int wr, int splits,
                                   int kc, int vec, void* stream) {
  if (B <= 0 || Cout <= 0 || Lout <= 0) return 0;
  if (Cin <= 0 || Lin <= 0 || (stride != 1 && stride != 2) || pad < 0 || (K != 1 && K != 3) ||
      Lout != (Lin + 2 * pad - K) / stride + 1 || (long long)B * Cin * Lin >= (1ll << 31) ||
      (long long)B * Cout * Lout >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int lk = lm > 0 ? 32 / lm : 0;
  const int Kw = Cin * K, M = B * Lout;
  if ((wr != 1 && wr != 2 && wr != 4 && wr != 8) || splits < 1 || splits > kMaxSplits ||
      lk == 0 || kc <= 0 || kc % (4 * lk) != 0 || (long long)splits * kc < Kw ||
      (long long)(splits - 1) * kc >= Kw || (Cout + wr * kTR - 1) / (wr * kTR) > 65535 ||
      (M + tm * lm - 1) / (tm * lm) > 65535 || (vec && Kw % 4 != 0))
    return (int)cudaErrorInvalidValue;
  Params p{(const float*)x, (const float*)w, (const float*)bias, (const float*)res, (float*)out,
           Cin, Lin, Cout, Lout, stride, pad, M, Kw, wr, kc};
  cudaStream_t s = (cudaStream_t)stream;
#define SURFD_CONV1D_CASE(KK, VV, TMM, LMM)                                      \
  if (K == KK && (vec != 0) == VV && tm == TMM && lm == LMM)                     \
    return (int)launch<KK, VV, TMM, LMM>(p, splits, s);
#define SURFD_CONV1D_CASES(KK, VV)     \
  SURFD_CONV1D_CASE(KK, VV, 8, 1)      \
  SURFD_CONV1D_CASE(KK, VV, 16, 1)     \
  SURFD_CONV1D_CASE(KK, VV, 16, 2)     \
  SURFD_CONV1D_CASE(KK, VV, 16, 4)
  SURFD_CONV1D_CASES(1, true)
  SURFD_CONV1D_CASES(1, false)
  SURFD_CONV1D_CASES(3, true)
  SURFD_CONV1D_CASES(3, false)
#undef SURFD_CONV1D_CASES
#undef SURFD_CONV1D_CASE
  return (int)cudaErrorInvalidValue;
}
