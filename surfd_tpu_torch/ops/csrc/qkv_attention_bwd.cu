// Gradient of the multi-head self-attention of qkv_attention.cu (K2-bwd):
// (qkv (B, T, 3*H*C), dO (B, T, H*C)) -> dqkv (B, T, 3*H*C).
//
// The TPU package had no backward kernel: `jax.grad` differentiated the XLA
// reference `qkv_attention` (surfd_tpu/models/layers.py:67-85) when it trained
// through the Pallas forward `_attn_kernel` (surfd_tpu/ops/attention_kernel.py,
// retired in commit a9ab519). This kernel is that gradient on the card, the
// backward of K2. With s = C^-1/4 and P = softmax(s^2 q k^T) per head, in f32:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  D = rowsum(P * dP),
//   dq = s^2 dS k,  dk = s^2 dS^T q.
// D is rowsum(dO * O) taken without O.
//
// What bounds it on an H100: neither bytes nor operations. At the denoiser's
// training shapes (T <= 64, C <= 128, B 2, 8 heads) a call moves well under a
// MB and does well under 10 MFLOP: its bound is a fraction of a microsecond.
// Its time is the launch and the longest serial chain of one CTA: global
// loads, then dependent passes through shared memory, each a few hundred
// cycles of latency however little it computes. One CTA per (batch, head),
// as this kernel first was, ran that whole chain on 16 of the 132 SMs at B 2,
// three column passes of one output a thread at two shared loads an FFMA.
//
// Design, aimed at that chain:
// - A thread-block cluster of R CTAs per (batch, head), R = ceil(T / 8) (8 at
//   T 64: 128 CTAs at B 2; 1 at T <= 8), grid (R, H, B). CTA r owns the query
//   rows and the key rows of block r (at most 8 each), so each chain is an
//   eighth as long.
// - Every CTA stages the head's q, k, v and dO token-major ([T][C|1], the
//   odd stride spreading a channel-first source's copies over the banks)
//   with 4-byte `cp.async`, all copies in flight at once. The scale s^2 is
//   applied to the products, not to the copies.
// - One pass computes the four score products: S_r = q_r k^T and dP_r =
//   dO_r V^T for its query rows, S[:, r] and dP[:, r] for its key rows.
// - Phase 1, query block r: a warp per row takes the max m, the sum l, P, D
//   and dS_r, and leaves the row's (m, l, D) in the CTA's shared memory.
// - Exchange: `cluster.sync()`, then each CTA reads every row's (m, l, D)
//   from its owner through distributed shared memory (`map_shared_rank`):
//   3 T floats cross the cluster, not the T x T P and dS. This is the split
//   of FlashAttention-2's backward, with the row statistics in place of a
//   stored log-sum-exp. Each CTA arrives on the cluster barrier once it has
//   read its peers and waits on it only before it exits, so that no CTA
//   leaves while a peer still reads its shared memory; no global store is
//   outstanding at either arrival, so the barrier's release fence waits for
//   none.
// - dq_r = s^2 dS_r k; phase 2, key block r: P[:, r] = exp(S - m) / l and
//   dS[:, r] from the statistics, then dk_r = s^2 dS[:, r]^T q and dV_r =
//   P[:, r]^T dO.
// - Every product is one small matrix product in f32 FFMA (`mm`, one
//   non-inlined copy for each tile shape): a thread owns a 4 x 4 (scores) or
//   2 x 4 (gradients) tile of outputs in registers, at most six shared loads
//   for eight FFMA; the depth is split over up to 32 lanes of a warp and
//   joined by shuffles in a fixed order. No atomics: two calls on the same
//   inputs give the same bits, which a CUDA graph of the train step relies
//   on. The tensor cores are not used: one TF32 pass misses the 2e-5 bar.
// - Layouts by strides, as K2's: qkv token-major or the transpose of a
//   contiguous (B, 3*H*C, T) tensor; dO the same two ways (what proj_out's
//   backward hands back); dqkv in qkv's layout, so that the qkv conv's
//   backward reads a contiguous (B, 3*H*C, T) gradient.
// - The kernel is file-local and launched only by the entry point below,
//   always with its cluster; a launch without it would map peers outside
//   the cluster, so the kernel checks its cluster's size and traps first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 64;   // two keys per lane in the softmax pass
constexpr int kMaxC = 128;
constexpr int kMaxRows = 8;  // query (and key) rows per CTA; R <= 8, the portable cluster size
constexpr int kTB = 4;  // columns of a thread's output tile in `mm`
constexpr unsigned kFull = 0xffffffffu;

// The cluster size R for T tokens, and the rows of each CTA's block.
__host__ __device__ constexpr int cluster_of(int T) { return (T + kMaxRows - 1) / kMaxRows; }
__host__ __device__ constexpr int rows_of(int T) { return (T + cluster_of(T) - 1) / cluster_of(T); }

// Dynamic shared memory of a CTA: q, k, v and dO, [T][C|1] each; four
// [rows][T|1] score tiles (S and dP of the query block, of the key block).
// 140,416 bytes at kMaxT, kMaxC.
__host__ __device__ constexpr size_t smem_floats(int T, int C) {
  return (size_t)4 * T * (C | 1) + (size_t)4 * rows_of(T) * (T | 1);
}

// Starts copying the (T, C) tile at src (token stride st, channel stride sc;
// the source's contiguous axis has stride 1) into shared memory at dst,
// token-major ([T][C|1]), by 4-byte copies. Consecutive threads take
// consecutive source addresses; indices step by additions, as a division
// per copy would cost more than its issue.
__device__ __forceinline__ void stage(const float* src, long long st, long long sc, int T, int C,
                                      float* dst) {
  const bool tok = sc == 1;  // rows of the source are tokens; else channels
  const int n = tok ? C : T, rows = tok ? T : C;
  const long long rs = tok ? st : sc;
  const int drow = tok ? C | 1 : 1, de = tok ? 1 : C | 1;  // dst steps between rows, copies
  const int step_row = kThreads / n, step_e = kThreads - step_row * n;
  int row = threadIdx.x / n, e = threadIdx.x - row * n;
  while (row < rows) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + row * drow + e * de);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + row * rs + e)
                 : "memory");
    e += step_e;
    row += step_row;
    if (e >= n) {
      e -= n;
      ++row;
    }
  }
}

// out[a * oa + b * ob] = mul * sum_{k < K} X[a * xa + k * xk] * Y[k * yk + b * yb]
// for a < A, b < N, computed by the `nthr` threads of a group (a multiple of
// 32 starting on a warp, its threads numbered tid from 0). X and Y are in
// shared memory, out in shared or global memory. A thread owns a kTA x kTB
// tile (4 x 4 for the score products, whose depth C is long; 2 x 4 for the
// gradient products, whose depth T is short and whose partial sums are then
// fewer to join), its rows and columns strided (a = ta + i * na, b = tb + j *
// nb) so that neighbouring lanes read neighbouring rows; the depth is split over
// ks lanes of a warp (a power of two, as many as the group has threads to
// spare), and their partial sums are joined by xor shuffles in a fixed
// order. Not inlined: every product of the kernel runs one of two copies of
// the code, which stay in the instruction cache after their first use.
template <int kTA>
__device__ __noinline__ void mm(const float* X, int xa, int xk, const float* Y, int yk, int yb,
                                int A, int N, int K, int tid, int nthr, float* out, long long oa,
                                long long ob, float mul) {
  const int na = (A + kTA - 1) / kTA, nb = (N + kTB - 1) / kTB, tiles = na * nb;
  int lks = 0;
  while (lks < 5 && (tiles << (lks + 1)) <= nthr && (2 << lks) <= K) ++lks;
  const int ks = 1 << lks, work = tiles << lks;
  for (int base = 0; base < work; base += nthr) {  // the same trip count in every lane
    const int idx = base + tid;
    const int part = idx & (ks - 1);
    const int tile = min(idx >> lks, tiles - 1);  // lanes past the work redo a tile, store nothing
    const int ta = tile / nb, tb = tile - ta * nb;
    const float* xp[kTA];
    const float* yp[kTB];
#pragma unroll
    for (int i = 0; i < kTA; ++i) xp[i] = X + min(ta + i * na, A - 1) * xa + part * xk;
#pragma unroll
    for (int j = 0; j < kTB; ++j) yp[j] = Y + min(tb + j * nb, N - 1) * yb + part * yk;
    const int xs = ks * xk, ys = ks * yk;
    float acc[kTA][kTB] = {};
#pragma unroll 2
    for (int k = part; k < K; k += ks) {
      float x[kTA], y[kTB];
#pragma unroll
      for (int i = 0; i < kTA; ++i) {
        x[i] = *xp[i];
        xp[i] += xs;
      }
#pragma unroll
      for (int j = 0; j < kTB; ++j) {
        y[j] = *yp[j];
        yp[j] += ys;
      }
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
#pragma unroll 1
    for (int o = ks >> 1; o; o >>= 1)
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
    if (part == 0 && idx < work) {
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) {
          const int a = ta + i * na, b = tb + j * nb;
          if (a < A && b < N) out[a * oa + b * ob] = mul * acc[i][j];
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
qkv_attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         float* __restrict__ dqkv, int T, int C, float scale, long long in_b,
                         long long in_t, long long in_c, long long go_b, long long go_t,
                         long long go_c, long long out_b, long long out_t, long long out_c) {
  extern __shared__ float sm[];
  __shared__ float4 own[kMaxRows];  // (m, l, D, -) of this CTA's query rows, read by its peers
  __shared__ float4 stats[kMaxT];   // (m, l, D, -) of every row, gathered from their owners
  const cg::cluster_group cluster = cg::this_cluster();
  const int R = gridDim.x, NR = (T + R - 1) / R;
  if (cluster.num_blocks() != (unsigned)R) __trap();  // launched without its cluster
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r0 = r * NR, nr = min(NR, T - r0);  // this CTA's query rows and key rows
  const int ldt = T | 1, ts = C | 1;
  float* qs = sm;                     // q, k, v, dO: element (t, c) at [t * ts + c]
  float* ks = qs + T * ts;
  float* vs = ks + T * ts;
  float* dos = vs + T * ts;
  float* s_row = dos + T * ts;        // [NR][ldt]: S of the query block, then dS
  float* dp_row = s_row + NR * ldt;   // [NR][ldt]: dP of the query block
  float* s_col = dp_row + NR * ldt;   // [NR][ldt]: S[:, block]^T, then P^T
  float* dp_col = s_col + NR * ldt;   // [NR][ldt]: dP[:, block]^T, then dS^T
  const float s2 = scale * scale;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* src = qkv + b * in_b + (long long)h * 3 * C * in_c;
  stage(src, in_t, in_c, T, C, qs);
  stage(src + C * in_c, in_t, in_c, T, C, ks);
  stage(src + 2 * C * in_c, in_t, in_c, T, C, vs);
  stage(dout + b * go_b + (long long)h * C * go_c, go_t, go_c, T, C, dos);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The four score products, a quarter of the CTA each: S_r = s^2 q_r k^T and
  // dP_r = dO_r V^T (phase 1), S[:, r]^T = s^2 k_r q^T and dP[:, r]^T = V_r dO^T
  // (phase 2, which needs no statistics).
  {
    const int quarter = tid >> 6;
    const float* x = quarter == 0 ? qs : quarter == 1 ? dos : quarter == 2 ? ks : vs;
    const float* y = quarter == 0 ? ks : quarter == 1 ? vs : quarter == 2 ? qs : dos;
    float* out = quarter == 0 ? s_row : quarter == 1 ? dp_row : quarter == 2 ? s_col : dp_col;
    mm<4>(x + r0 * ts, ts, 1, y, 1, ts, nr, T, C, tid & 63, 64, out, ldt, 1,
          quarter == 0 || quarter == 2 ? s2 : 1.0f);
  }
  __syncthreads();

  // A warp per query row: m, l, P, D = sum P dP, dS = P (dP - D), in place of
  // S; the row's (m, l, D) for the peers.
  if (warp < nr) {
    float* srow = s_row + warp * ldt;
    const float* prow = dp_row + warp * ldt;
    const bool in0 = lane < T, in1 = lane + 32 < T;
    const float l0 = in0 ? srow[lane] : -INFINITY;
    const float l1 = in1 ? srow[lane + 32] : -INFINITY;
    float m = fmaxf(l0, l1);
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float e0 = in0 ? expf(l0 - m) : 0.0f;
    const float e1 = in1 ? expf(l1 - m) : 0.0f;
    float sum = e0 + e1;
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    const float p0 = e0 / sum, p1 = e1 / sum;
    const float d0 = in0 ? prow[lane] : 0.0f, d1 = in1 ? prow[lane + 32] : 0.0f;
    float dsum = p0 * d0 + p1 * d1;
    for (int o = 16; o; o >>= 1) dsum += __shfl_xor_sync(kFull, dsum, o);
    if (in0) srow[lane] = p0 * (d0 - dsum);
    if (in1) srow[lane + 32] = p1 * (d1 - dsum);
    if (lane == 0) own[warp] = make_float4(m, sum, dsum, 0.0f);
  }

  // The exchange: every row's statistics from the CTA that owns it. The
  // cluster barrier is also the CTA's barrier for dS_r.
  cluster.sync();
  if (tid < T) {
    const int owner = tid / NR;
    stats[tid] = cluster.map_shared_rank(own, owner)[tid - owner * NR];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");  // done reading peers
  __syncthreads();

  // dq_r = s^2 dS_r k, into dqkv (q | k | v of head h).
  float* dst = dqkv + b * out_b + (long long)h * 3 * C * out_c + r0 * out_t;
  mm<2>(s_row, ldt, 1, ks, ts, 1, nr, C, T, tid, kThreads, dst, out_t, out_c, s2);

  // P[:, r] and dS[:, r] from the statistics, in place of S and dP.
  for (int e = tid; e < nr * ldt; e += kThreads) {
    const int i = e % ldt;
    if (i < T) {
      const float4 st = stats[i];
      const float p = expf(s_col[e] - st.x) / st.y;
      s_col[e] = p;
      dp_col[e] = p * (dp_col[e] - st.z);
    }
  }
  __syncthreads();

  // dk_r = s^2 dS[:, r]^T q and dV_r = P[:, r]^T dO, a half of the CTA each.
  const int half = tid >> 7;
  mm<2>(half ? s_col : dp_col, ldt, 1, half ? dos : qs, ts, 1, nr, C, T, tid & 127, 128,
        dst + (half ? 2 : 1) * C * out_c, out_t, out_c, half ? 1.0f : s2);

  // No CTA leaves while a peer may still read its statistics.
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

// Strides are in elements, for the (batch, token, channel) axes of qkv, dO
// and dqkv; the wrapper admits exactly the two layouts described above.
// Returns the launch's cudaError_t (a refused cluster launch included).
extern "C" int surfd_qkv_attention_bwd(const void* qkv, const void* dout, void* dqkv, int B,
                                       int T, int H, int C, float scale, long long in_b,
                                       long long in_t, long long in_c, long long go_b,
                                       long long go_t, long long go_c, long long out_b,
                                       long long out_t, long long out_c, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (T > kMaxT || C <= 0 || C > kMaxC || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // The opt-in above 48 KB costs a CUDA API call: made once per device, at the
  // kernel's largest size, not on every launch.
  static unsigned long long opted_in = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted_in >> dev & 1)) {
    e = cudaFuncSetAttribute(qkv_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(smem_floats(kMaxT, kMaxC) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  const int R = cluster_of(T);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_floats(T, C) * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qkv_attention_bwd_kernel, (const float*)qkv, (const float*)dout,
                         (float*)dqkv, T, C, scale, in_b, in_t, in_c, go_b, go_t, go_c, out_b,
                         out_t, out_c);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
