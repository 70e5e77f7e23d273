// Multi-head self-attention on a fused heads-major qkv: (B, T, 3*H*C) -> (B, T, H*C).
//
// Replaces the TPU kernel `_attn_kernel` / `pallas_qkv_attention` of
// surfd_tpu/ops/attention_kernel.py (retired in commit a9ab519; the live XLA
// reference is `qkv_attention` in surfd_tpu/models/layers.py). It is
// QKVAttentionLegacy: per head h the channels [h*3C, h*3C+3C) of a token hold
// q, k and v; q and k are each scaled by 1/sqrt(sqrt(C)); softmax in f32.
//
// What bounds it on an H100: neither bytes nor operations. The denoiser's
// shapes are tiny — T <= 64 tokens, C <= 128 channels — so a launch moves
// well under a MB and does well under a MFLOP. Its time is the launch, the
// staging of the head in shared memory, and the serial chain of the
// slowest warp.
//
// Design, aimed at that latency:
// - Many CTAs: one per (batch, head, block of kRows query rows), so at T 32
//   and B 2 the 128 CTAs spread over the SMs instead of 16 of them.
// - Each CTA stages the head's K and V and its own q rows in shared memory,
//   in 16-byte loads where the layout is aligned for them, along whichever
//   axis of the input is contiguous (shifts and masks, no divides). Rows
//   are padded to an odd stride, so that lanes reading different key rows
//   hit different banks.
// - One warp per query row. A lane takes the logit against one key (two at
//   T > 32); at T <= 16 the lanes a key leaves idle split its channel sum,
//   joined by shuffles. Max and sum are warp shuffles; lane j then takes
//   output channels j, j + 32, ..., with each weight broadcast by a shuffle.
// - Two layouts in and out, by strides: token-major (channel axis
//   contiguous) and the transpose of a contiguous (B, 3*H*C, T) tensor, what
//   a 1x1 Conv1d writes. A channel-first output tile goes through shared
//   memory so that its stores run along t.
// - Exact f32 on the FFMA pipes: `expf`, weights = e / sum, then sum_s w_s v_s,
//   as the reference does. At these sizes the tensor cores buy nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;    // query rows per CTA, one warp each
constexpr int kMaxT = 64;   // two keys per lane
constexpr int kMaxC = 128;  // four output channels per lane
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a CTA of `rows` query rows of a (T, C) head: K,
// V and its q rows, and the channel-first output tile, rows padded to an
// odd stride; 70,672 bytes at kMaxT, kMaxC, kRows.
constexpr size_t smem_bytes(int T, int C, int rows) {
  return ((size_t)(2 * T + rows) * (C | 1) + (size_t)C * (rows | 1)) * sizeof(float);
}

template <int N>
struct alignas(4 * N) Floats {
  float f[N];
};

// Copies an (nseg, n) tile whose row seg starts at src + seg * stride and is
// contiguous: st(seg, e, x) receives element e of row seg. Consecutive
// threads take consecutive kVec-float vectors of a row, so that loads
// coalesce; e runs over n / kVec rounded up to a power of two. A thread
// issues kBatch loads before it stores any, so that one round trip to L2
// covers them. Needs n % kVec == 0 and 4 * kVec-byte aligned rows.
template <int kVec, int kBatch, typename St>
__device__ __forceinline__ void load_tile(const float* src, int stride, int nseg, int n, St st) {
  const int nv = n / kVec;
  const int lg = 32 - __clz(nv - 1);  // ceil(log2(nv)); 0 for nv 1
  const int mask = (1 << lg) - 1, total = nseg << lg;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    Floats<kVec> buf[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * blockDim.x;
      if (idx < total && (idx & mask) < nv)
        buf[i] = *reinterpret_cast<const Floats<kVec>*>(src + (idx >> lg) * stride +
                                                         (idx & mask) * kVec);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * blockDim.x;
      if (idx < total && (idx & mask) < nv) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) st(idx >> lg, (idx & mask) * kVec + k, buf[i].f[k]);
      }
    }
  }
}

template <int kVec>
__global__ void __launch_bounds__(kRows * 32)
qkv_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T, int C,
                     float scale, long long in_b, int in_t, int in_c, long long out_b,
                     int out_t, int out_c) {
  extern __shared__ float sm[];
  const int rows = blockDim.x >> 5;
  const int ld = C | 1;       // odd row stride: lanes reading different rows hit different banks
  const int old = rows | 1;   // the same for the output tile's rows
  float* ks = sm;             // [T][ld], scaled
  float* vs = ks + T * ld;    // [T][ld]
  float* qs = vs + T * ld;    // [rows][ld], scaled
  float* os = qs + rows * ld; // [C][old], output tile of a channel-first output
  const int t0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int nr = min(rows, T - t0);
  const float* src = qkv + b * in_b + h * 3 * C * in_c;

  auto st_kv = [&](int s, int cc, float x) {  // channel cc < 2C of the head's k|v, token s
    if (cc < C) ks[s * ld + cc] = x * scale;
    else vs[s * ld + cc - C] = x;
  };
  auto st_q = [&](int r, int j, float x) { qs[r * ld + j] = x * scale; };
  if (in_c == 1) {  // token-major: token s holds q, k, v of the head, 3C floats
    load_tile<kVec, 16 / kVec>(src + C, in_t, T, 2 * C, st_kv);
    load_tile<1, 4>(src + t0 * in_t, in_t, nr, C, st_q);
  } else {          // channel-first: channel cc holds T floats
    load_tile<kVec, 16 / kVec>(src + C * in_c, in_c, 2 * C, T,
                               [&](int cc, int s, float x) { st_kv(s, cc, x); });
    load_tile<1, 4>(src + t0 * in_t, in_c, C, nr, [&](int j, int r, float x) { st_q(r, j, x); });
  }
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dst = out + b * out_b + h * C * out_c;
  if (w < nr) {
    // Lane = slice * kp + key: kp keys per pass (T rounded up to a power of
    // two, at most 32), and the 32 / kp lanes of one key each sum a slice of
    // the channels. Lanes past T read a real row and are masked below.
    const int lg_kp = T > 32 ? 5 : 32 - __clz(T - 1);
    const int kp = 1 << lg_kp, key = lane & (kp - 1);
    const int chunk = (C + (32 >> lg_kp) - 1) >> (5 - lg_kp);
    const int j0 = min(C, (lane >> lg_kp) * chunk), j1 = min(C, j0 + chunk);
    const float* q = qs + w * ld;
    const float* k0 = ks + min(key, T - 1) * ld;
    const float* k1 = ks + min(key + 32, T - 1) * ld;
    // four partial sums, so that the loads and FMAs of one step do not wait
    // on the previous step's
    float a0[4] = {}, a1[4] = {};
    int i = j0;
    if (T > 32) {
      for (; i + 4 <= j1; i += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a0[u] = fmaf(q[i + u], k0[i + u], a0[u]);
          a1[u] = fmaf(q[i + u], k1[i + u], a1[u]);
        }
      }
      for (; i < j1; ++i) {
        a0[0] = fmaf(q[i], k0[i], a0[0]);
        a1[0] = fmaf(q[i], k1[i], a1[0]);
      }
    } else {
      for (; i + 4 <= j1; i += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a0[u] = fmaf(q[i + u], k0[i + u], a0[u]);
      }
      for (; i < j1; ++i) a0[0] = fmaf(q[i], k0[i], a0[0]);
    }
    float l0 = (a0[0] + a0[1]) + (a0[2] + a0[3]);
    float l1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
    for (int o = 16; o >= kp; o >>= 1) l0 += __shfl_xor_sync(kFull, l0, o);  // join the slices
    l0 = key < T ? l0 : -INFINITY;
    l1 = key + 32 < T ? l1 : -INFINITY;
    float m = fmaxf(l0, l1);
    for (int o = kp >> 1; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float e0 = key < T ? expf(l0 - m) : 0.0f;
    const float e1 = key + 32 < T ? expf(l1 - m) : 0.0f;
    float sum = e0 + e1;
    for (int o = kp >> 1; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    const float w0 = e0 / sum, w1 = e1 / sum;  // lane s holds key s's (and key s + 32's)

    // Two loops, keys below 32 and above, so that no select of w0 or w1
    // reaches the shuffle: with one, the compiler redoes the division per key.
    float acc[kMaxC / 32] = {};
    auto add_row = [&](int s, float ws) {
      const float* v = vs + s * ld;
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < C) acc[u] = fmaf(ws, v[j], acc[u]);
      }
    };
    const int t_lo = min(T, 32);
#pragma unroll 4
    for (int s = 0; s < t_lo; ++s) add_row(s, __shfl_sync(kFull, w0, s));
#pragma unroll 4
    for (int s = 32; s < T; ++s) add_row(s, __shfl_sync(kFull, w1, s - 32));
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u) {
      const int j = lane + 32 * u;
      if (j >= C) break;
      if (out_c == 1) dst[(t0 + w) * out_t + j] = acc[u];
      else os[j * old + w] = acc[u];
    }
  }
  if (out_c != 1) {  // channel-first: stores run along t
    __syncthreads();
    const int lg = 32 - __clz(nr - 1), total = C << lg;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int j = i >> lg, r = i & ((1 << lg) - 1);
      if (r < nr) dst[j * out_c + (t0 + r) * out_t] = os[j * old + r];
    }
  }
}

}  // namespace

// Strides are in elements, for the (batch, token, channel) axes of qkv and
// out; the wrapper admits exactly the two layouts described above. Returns
// the launch's cudaError_t.
extern "C" int surfd_qkv_attention(const void* qkv, void* out, int B, int T, int H, int C,
                                   float scale, long long in_b, long long in_t, long long in_c,
                                   long long out_b, long long out_t, long long out_c,
                                   void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (T > kMaxT || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  // 16-byte staging loads when every row of k|v starts 16-byte aligned
  const bool tok = in_c == 1;
  const long long row = tok ? in_t : in_c, n = tok ? C : T;
  const bool vec = (uintptr_t)qkv % 16 == 0 && n % 4 == 0 && row % 4 == 0 &&
                   (B == 1 || in_b % 4 == 0);
  auto kernel = vec ? qkv_attention_kernel<4> : qkv_attention_kernel<1>;
  const int rows = T < kRows ? T : kRows;
  const size_t smem = smem_bytes(T, C, rows);
  // The opt-in above 48 KB costs a CUDA API call: made once per device and
  // kernel, at the kernel's largest size, not on every launch.
  static unsigned long long opted_in[2] = {0, 0};  // a bit per device, per kernel
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted_in[vec] >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxT, kMaxC, kRows));
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[vec] |= 1ull << dev;
  }
  dim3 grid((T + rows - 1) / rows, H, B);
  kernel<<<grid, rows * 32, smem, (cudaStream_t)stream>>>(
      (const float*)qkv, (float*)out, T, C, scale, in_b, (int)in_t, (int)in_c, out_b,
      (int)out_t, (int)out_c);
  return (int)cudaGetLastError();
}
