// Folded CBN-decoder MLP: points (P, 3) -> UDF (P,).
//
// Replaces the TPU kernel `_decoder_kernel` / `pallas_folded_udf` of
// surfd_tpu/ops/decoder_kernel.py (retired in commit a9ab519; the live XLA
// reference is `folded_udf` / `folded_udf_mixed` there). For one latent the
// conditional batch norms fold into affines, so the decoder is
//
//   x  = posenc(p) @ W_in + b_in                      posenc: f32, 3 -> 63
//   L times:  h = relu(a1*x + c1) @ W1 + b1
//             x = x + relu(a2*h + c2) @ W2 + b2
//   udf = (1 - sigmoid(relu(a_out*x + c_out) @ w_out + b_out)) * max_dist
//
// What bounds it on an H100: arithmetic. At H = 512, L = 5 a point costs
// about 2.65 M multiply-adds, against 12 bytes in and 4 bytes out, so the
// kernel sits far above the card's operations-per-byte line. This first
// version runs the multiply-adds on the FP32 pipes (FFMA), not the tensor
// cores.
//
// Design: one CTA takes a tile of kTile = 32 points and keeps every
// activation of the tile on the SM across all L blocks, so none goes back to
// device memory. Thread n owns hidden unit n (blockDim = H <= 512): the
// residual stream x[n][0..31] and the 32 sums of its output column live in
// its registers; the matmul input A (H x 32 floats, 64 KB at H = 512) lives
// in shared memory, stored [unit][point]. In the inner loop the thread reads
// its weight W[k][n] from global memory (coalesced across the warp; the
// 10.5 MB of f32 weights stay in the 50 MB L2) and A[k][0..31] as eight
// broadcast float4 loads, one address per warp, for 32 FFMAs.
//
// Precision: template on the matmul input type W; only W = float, the
// float32 folded decoder, is instantiated. The bf16-input variant runs on
// the tensor cores in folded_mlp_bf16.cu. The elementwise affines use
// explicitly rounded multiply and add (no contraction into FMA) to round as
// the reference does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // points per CTA

template <typename W> __device__ __forceinline__ float wload(const W* p);
template <> __device__ __forceinline__ float wload<float>(const float* p) { return __ldg(p); }

// Round a matmul input to the weight type (identity for float).
template <typename W> __device__ __forceinline__ float round_in(float x);
template <> __device__ __forceinline__ float round_in<float>(float x) { return x; }

__device__ __forceinline__ float affine_relu(float x, float a, float c) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), c), 0.0f);
}

// acc[t] += sum_k A[k][t] * Wm[k][col] over a K-row input A stored [k][t].
template <typename W>
__device__ __forceinline__ void matmul_col(const float* __restrict__ A, const W* __restrict__ Wm,
                                           int K, int H, int col, float acc[kTile]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float w = wload<W>(Wm + (size_t)k * H + col);
    const float4* a4 = reinterpret_cast<const float4*>(A + k * kTile);
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      const float4 a = a4[q];
      acc[4 * q + 0] = fmaf(a.x, w, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
    }
  }
}

__device__ __forceinline__ void store_row(float* row, const float v[kTile]) {
  float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int q = 0; q < kTile / 4; ++q) r4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// kResidualFirst: x + (acc + b2) for the f32 reference (`folded_udf`),
// (x + acc) + b2 for the mixed one (`folded_udf_mixed`).
template <typename W, bool kResidualFirst>
__global__ void __launch_bounds__(512)
folded_mlp_kernel(const float* __restrict__ pts, int64_t P, int H, int L,
                  const W* __restrict__ w_in, const float* __restrict__ b_in,
                  const float* __restrict__ a1, const float* __restrict__ c1,
                  const W* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ a2, const float* __restrict__ c2,
                  const W* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ a_out, const float* __restrict__ c_out,
                  const W* __restrict__ w_out, float b_out, float max_dist,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // [H][kTile] matmul input
  const int col = threadIdx.x;                  // this thread's hidden unit
  const int64_t p0 = (int64_t)blockIdx.x * kTile;

  // Positional encoding into A rows 0..62: [x, sin(f0 x), cos(f0 x), ...]
  // with f_i = 2^i; points past P (ragged last tile) encode the origin.
  for (int i = threadIdx.x; i < 63 * kTile; i += blockDim.x) {
    const int j = i / kTile, t = i % kTile;
    const int64_t p = p0 + t;
    float v;
    if (j < 3) {
      v = p < P ? pts[p * 3 + j] : 0.0f;
    } else {
      const int r = (j - 3) % 6, fi = (j - 3) / 6;
      const float x = p < P ? pts[p * 3 + (r % 3)] : 0.0f;
      const float xf = x * (float)(1 << fi);  // exact: power of two
      v = r < 3 ? sinf(xf) : cosf(xf);
    }
    A[j * kTile + t] = round_in<W>(v);
  }
  __syncthreads();

  float acc[kTile];
  float x[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
  matmul_col<W>(A, w_in, 63, H, col, acc);
  {
    const float b = b_in[col];
#pragma unroll
    for (int t = 0; t < kTile; ++t) x[t] = acc[t] + b;
  }

  for (int l = 0; l < L; ++l) {
    const size_t lo = (size_t)l * H;
    const size_t wo = (size_t)l * H * H;
    {
      const float a = a1[lo + col], c = c1[lo + col];
      float h[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) h[t] = round_in<W>(affine_relu(x[t], a, c));
      __syncthreads();  // everyone is done reading A
      store_row(A + col * kTile, h);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
    matmul_col<W>(A, w1 + wo, H, H, col, acc);
    {
      const float b = b1[lo + col], a = a2[lo + col], c = c2[lo + col];
      float h[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) h[t] = round_in<W>(affine_relu(acc[t] + b, a, c));
      __syncthreads();
      store_row(A + col * kTile, h);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
    matmul_col<W>(A, w2 + wo, H, H, col, acc);
    {
      const float b = b2[lo + col];
#pragma unroll
      for (int t = 0; t < kTile; ++t) x[t] = kResidualFirst ? x[t] + (acc[t] + b) : (x[t] + acc[t]) + b;
    }
  }

  // Output projection: each unit's term per point into A, then one thread
  // per point sums the H terms.
  {
    const float a = a_out[col], c = c_out[col];
    const float w = wload<W>(w_out + col);
    float h[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) h[t] = round_in<W>(affine_relu(x[t], a, c)) * w;
    __syncthreads();
    store_row(A + col * kTile, h);
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int t = threadIdx.x;
    float logit = 0.0f;
    for (int n = 0; n < H; ++n) logit += A[n * kTile + t];
    logit += b_out;
    const int64_t p = p0 + t;
    if (p < P) out[p] = (1.0f - 1.0f / (1.0f + expf(-logit))) * max_dist;
  }
}

template <typename W, bool kResidualFirst>
int launch(const void* pts, int64_t P, int H, int L, const void* w_in, const void* b_in,
           const void* a1, const void* c1, const void* w1, const void* b1, const void* a2,
           const void* c2, const void* w2, const void* b2, const void* a_out, const void* c_out,
           const void* w_out, float b_out, float max_dist, void* out, void* stream) {
  if (P <= 0) return 0;
  const size_t smem = (size_t)H * kTile * sizeof(float);
  auto kern = folded_mlp_kernel<W, kResidualFirst>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (P + kTile - 1) / kTile;
  kern<<<(unsigned)tiles, H, smem, (cudaStream_t)stream>>>(
      (const float*)pts, P, H, L, (const W*)w_in, (const float*)b_in, (const float*)a1,
      (const float*)c1, (const W*)w1, (const float*)b1, (const float*)a2, (const float*)c2,
      (const W*)w2, (const float*)b2, (const float*)a_out, (const float*)c_out, (const W*)w_out,
      b_out, max_dist, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int surfd_folded_mlp_f32(const void* pts, int64_t P, int H, int L, const void* w_in,
                                    const void* b_in, const void* a1, const void* c1,
                                    const void* w1, const void* b1, const void* a2, const void* c2,
                                    const void* w2, const void* b2, const void* a_out,
                                    const void* c_out, const void* w_out, float b_out,
                                    float max_dist, void* out, void* stream) {
  return launch<float, true>(pts, P, H, L, w_in, b_in, a1, c1, w1, b1, a2, c2, w2, b2, a_out,
                             c_out, w_out, b_out, max_dist, out, stream);
}
