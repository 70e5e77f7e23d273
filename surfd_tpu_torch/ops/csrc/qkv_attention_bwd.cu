// Gradient of the multi-head self-attention of qkv_attention.cu (K2-bwd):
// (qkv (B, T, 3*H*C), dO (B, T, H*C)) -> dqkv (B, T, 3*H*C).
//
// The TPU package had no backward kernel: `jax.grad` differentiated the XLA
// reference `qkv_attention` (surfd_tpu/models/layers.py:67-85) when it trained
// through the Pallas forward `_attn_kernel` (surfd_tpu/ops/attention_kernel.py,
// retired in commit a9ab519). This kernel is that gradient on the card, the
// backward of K2. With s = C^-1/4, q~ = s q, k~ = s k, P = softmax(q~ k~^T)
// (per head, f32):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - rowsum(dO * O)),
//   dq = s dS k~ = s^2 dS k,  dk = s dS^T q~ = s^2 dS^T q.
// rowsum(dO * O) is taken as rowsum(P * dP), the same sum without O.
//
// What bounds it on an H100: neither bytes nor operations. At the denoiser's
// training shapes (T <= 64, C <= 128, B 2, 8 heads) a call moves well under a
// MB (qkv and dO read once, dqkv written once) and does well under 10 MFLOP;
// the bound is a fraction of a microsecond. Its time is the launch and the
// serial chain of one CTA: staging the head, then three column passes.
//
// Design, simple first (a later PR may spread a head over more CTAs or use
// the tensor cores):
// - One CTA of 256 threads per (batch, head). Q~, K~, V and dO (T x C each)
//   and P and dS (T x T each) sit in dynamic shared memory, rows padded to an
//   odd stride so that lanes reading different rows hit different banks:
//   165,376 bytes at T 64, C 128, hence the opt-in above 48 KB.
// - The softmax is recomputed, not stored by the forward: a warp per query
//   row, a lane per key (two at T > 32), max and sums by shuffles, `expf`
//   and e / sum as K2 does. The same warp forms dP, the row's D and dS.
// - Column passes for dV, dq and dk: a thread per output element, a sum
//   over T in f32 FFMA. The element order follows the output's contiguous
//   axis, so that the stores coalesce in either layout.
// - Layouts by strides, as K2's: qkv token-major or the transpose of a
//   contiguous (B, 3*H*C, T) tensor; dO the same two ways (what proj_out's
//   backward hands back); dqkv in qkv's layout, so that the qkv conv's
//   backward reads a contiguous (B, 3*H*C, T) gradient. Loads are strided
//   scalar loads along the contiguous axis.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 64;   // two keys per lane
constexpr int kMaxC = 128;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a (T, C) head: Q~, K~, V, dO and P, dS, rows
// padded to an odd stride; 165,376 bytes at kMaxT, kMaxC.
constexpr size_t smem_bytes(int T, int C) {
  return ((size_t)4 * T * (C | 1) + (size_t)2 * T * (T | 1)) * sizeof(float);
}

// Copies the (T, n) tile at src (token stride st, channel stride sc) into
// dst[t * ld + j] * mul, walking the source's contiguous axis fastest.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, long long st,
                                          long long sc, int T, int n, float* dst, int ld,
                                          float mul) {
  const int total = T * n;
  if (sc == 1) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int t = i / n, j = i - t * n;
      dst[t * ld + j] = src[t * st + j] * mul;
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int j = i / T, t = i - j * T;
      dst[t * ld + j] = src[j * sc + t * st] * mul;
    }
  }
}

// out[t][j] = mul * sum_u A(t, u) * X[u][j] for t < T, j < C, where A(t, u) =
// a[t * lda + u] (trans false) or a[u * lda + t] (trans true); stored at
// dst + t * st + j * sc, the contiguous axis of dst walked fastest.
template <bool kTrans>
__device__ __forceinline__ void column_pass(const float* a, int lda, const float* x, int ldx,
                                            int T, int C, float mul, float* __restrict__ dst,
                                            long long st, long long sc) {
  const int total = T * C;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int t, j;
    if (sc == 1) {
      t = i / C;
      j = i - t * C;
    } else {
      j = i / T;
      t = i - j * T;
    }
    float acc0 = 0.0f, acc1 = 0.0f;
    int u = 0;
    for (; u + 2 <= T; u += 2) {
      const float a0 = kTrans ? a[u * lda + t] : a[t * lda + u];
      const float a1 = kTrans ? a[(u + 1) * lda + t] : a[t * lda + u + 1];
      acc0 = fmaf(a0, x[u * ldx + j], acc0);
      acc1 = fmaf(a1, x[(u + 1) * ldx + j], acc1);
    }
    if (u < T) acc0 = fmaf(kTrans ? a[u * lda + t] : a[t * lda + u], x[u * ldx + j], acc0);
    dst[t * st + j * sc] = mul * (acc0 + acc1);
  }
}

__global__ void __launch_bounds__(kThreads)
qkv_attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         float* __restrict__ dqkv, int T, int C, float scale, long long in_b,
                         long long in_t, long long in_c, long long go_b, long long go_t,
                         long long go_c, long long out_b, long long out_t, long long out_c) {
  extern __shared__ float sm[];
  const int ld = C | 1;   // odd row stride of the T x C tiles
  const int ldp = T | 1;  // the same for P and dS
  float* qs = sm;               // [T][ld], scaled by s
  float* ks = qs + T * ld;      // [T][ld], scaled by s
  float* vs = ks + T * ld;      // [T][ld]
  float* dos = vs + T * ld;     // [T][ld]
  float* ps = dos + T * ld;     // [T][ldp], P
  float* dss = ps + T * ldp;    // [T][ldp], dS
  const int h = blockIdx.x, b = blockIdx.y;
  const float* src = qkv + b * in_b + (long long)h * 3 * C * in_c;
  load_tile(src, in_t, in_c, T, C, qs, ld, scale);
  load_tile(src + C * in_c, in_t, in_c, T, C, ks, ld, scale);
  load_tile(src + 2 * C * in_c, in_t, in_c, T, C, vs, ld, 1.0f);
  load_tile(dout + b * go_b + (long long)h * C * go_c, go_t, go_c, T, C, dos, ld, 1.0f);
  __syncthreads();

  // A warp per query row: P, dP, D = rowsum(P * dP) and dS.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = min(lane, T - 1), k1 = min(lane + 32, T - 1);  // lanes past T read a real row
  for (int r = warp; r < T; r += kThreads / 32) {
    const float* q = qs + r * ld;
    const float* dor = dos + r * ld;
    const float* kr0 = ks + k0 * ld;
    const float* kr1 = ks + k1 * ld;
    const float* vr0 = vs + k0 * ld;
    const float* vr1 = vs + k1 * ld;
    float l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
    for (int j = 0; j < C; ++j) {
      const float qj = q[j], gj = dor[j];
      l0 = fmaf(qj, kr0[j], l0);
      d0 = fmaf(gj, vr0[j], d0);
      if (T > 32) {
        l1 = fmaf(qj, kr1[j], l1);
        d1 = fmaf(gj, vr1[j], d1);
      }
    }
    const bool in0 = lane < T, in1 = lane + 32 < T;
    l0 = in0 ? l0 : -INFINITY;
    l1 = in1 ? l1 : -INFINITY;
    float m = fmaxf(l0, l1);
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float e0 = in0 ? expf(l0 - m) : 0.0f;
    const float e1 = in1 ? expf(l1 - m) : 0.0f;
    float sum = e0 + e1;
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    const float p0 = e0 / sum, p1 = e1 / sum;
    float dsum = p0 * d0 + p1 * d1;  // D = sum_j P_rj dP_rj
    for (int o = 16; o; o >>= 1) dsum += __shfl_xor_sync(kFull, dsum, o);
    if (in0) {
      ps[r * ldp + lane] = p0;
      dss[r * ldp + lane] = p0 * (d0 - dsum);
    }
    if (in1) {
      ps[r * ldp + lane + 32] = p1;
      dss[r * ldp + lane + 32] = p1 * (d1 - dsum);
    }
  }
  __syncthreads();

  // Column passes into dqkv (q | k | v of head h): dq = s dS k~, dk = s dS^T q~, dV = P^T dO.
  float* dst = dqkv + b * out_b + (long long)h * 3 * C * out_c;
  column_pass<false>(dss, ldp, ks, ld, T, C, scale, dst, out_t, out_c);
  column_pass<true>(dss, ldp, qs, ld, T, C, scale, dst + C * out_c, out_t, out_c);
  column_pass<true>(ps, ldp, dos, ld, T, C, 1.0f, dst + 2 * C * out_c, out_t, out_c);
}

}  // namespace

// Strides are in elements, for the (batch, token, channel) axes of qkv, dO
// and dqkv; the wrapper admits exactly the two layouts described above.
// Returns the launch's cudaError_t.
extern "C" int surfd_qkv_attention_bwd(const void* qkv, const void* dout, void* dqkv, int B,
                                       int T, int H, int C, float scale, long long in_b,
                                       long long in_t, long long in_c, long long go_b,
                                       long long go_t, long long go_c, long long out_b,
                                       long long out_t, long long out_c, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (T > kMaxT || C <= 0 || C > kMaxC || H <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, C);
  // The opt-in above 48 KB costs a CUDA API call: made once per device, at the
  // kernel's largest size, not on every launch.
  static unsigned long long opted_in = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted_in >> dev & 1)) {
    e = cudaFuncSetAttribute(qkv_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxT, kMaxC));
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  dim3 grid(H, B);
  qkv_attention_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)dout, (float*)dqkv, T, C, scale, in_b, in_t, in_c, go_b,
      go_t, go_c, out_b, out_t, out_c);
  return (int)cudaGetLastError();
}
