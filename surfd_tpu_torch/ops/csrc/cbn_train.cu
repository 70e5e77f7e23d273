// The AE decoder's train-mode conditional BatchNorm + ReLU: forward, backward
// and the backward's backward (ops/cbn_train.py gives the formulas and their
// plain versions).
//
// Replaces no TPU kernel: the JAX package left the decoder's BatchNorm to XLA
// (flax nn.BatchNorm in surfd_tpu/models/decoder.py). The port composed it of
// elementwise and reduce kernels, each of the three graphs of the AE step
// (forward, create-graph coordinate gradient, loss.backward with its double
// backward) moving the (B·Q, C) activation a dozen times over.
//
// What bounds it: bytes. Every stage is a sum over the rows per (item,
// channel) followed by a pointwise pass; at the AE step's 160,000 × 512 f32
// rows one activation is 328 MB, 0.1 ms at 3.35 TB/s, and the arithmetic is a
// few operations a byte. The design reads each activation at most twice a
// stage (once to reduce, once to apply) and stores nothing but the outputs:
// x̂, z and the ReLU mask are recomputed from x and the per-channel μ, r, k.
//
// Each stage is three launches on the caller's stream:
//  1. reduce<stage>: a CTA owns a slab of `slab` rows of one item and a tile
//     of 32 channel groups (16-byte loads along the contiguous channels where
//     C % 4 == 0, else 4-byte); its 8 warps walk the rows, each thread keeps
//     its sums in registers, the warps are combined in a fixed order through
//     shared memory and the CTA writes its partial sums to scratch;
//  2. finalize<stage>: a CTA a tile of 32 channels sums the partials over the
//     slabs in a fixed order (per item), then one thread a channel sums over
//     the items and derives the coefficients of the pointwise pass;
//  3. apply<stage>: the slab grid again, each thread its channel group's
//     coefficients in registers, one pass over the rows.
// No float atomics: two runs give the same bits.
//
// z is rounded as torch rounds γ·x̂ + β (a product, then a sum; x̂ a
// difference, then a product), so that every stage reads the same mask.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // channel groups of a tile: one warp along the channels
constexpr int kWarps = 8;   // rows in flight in a CTA: one a warp
constexpr int kThreads = kLanes * kWarps;

enum Stage { kFwd = 0, kBwd = 1, kBwd2 = 2 };

template <int S>
__host__ __device__ constexpr int num_sums() { return S == kBwd2 ? 5 : 2; }

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ float xhat(float x, float mu, float rs) {
  return __fmul_rn(__fsub_rn(x, mu), rs);
}

__device__ __forceinline__ float zval(float g, float xh, float be) {
  return __fadd_rn(__fmul_rn(g, xh), be);
}

// The ReLU's mask as torch's threshold_backward reads it (a NaN passes).
__device__ __forceinline__ bool live(float z) { return !(z <= 0.f); }

// Pointers of one stage's passes. Per channel: stats (μ, r, k) and coef;
// per (item, channel): gamma, beta, ga, ba (the cotangents of gγ, gβ), pb.
struct Args {
  const float* x; const float* gh; const float* a;
  const float* gamma; const float* beta; const float* ga; const float* ba;
  const float* stats; const float* coef; const float* pb;
  float* out0; float* out1;  // h | gx | ggh, gx
  int Q, C, slab;
};

template <int S, int V>
__global__ void __launch_bounds__(kThreads) reduce(Args p, float* __restrict__ partial) {
  constexpr int NS = num_sums<S>();
  __shared__ float sh[kWarps][NS][kLanes * V];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int c0 = (blockIdx.x * kLanes + lane) * V;
  const int slab = blockIdx.y, b = blockIdx.z;
  float acc[NS][V];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[s][j] = 0.f;
  if (c0 < p.C) {
    float mu[V], rs[V], g[V], be[V];
    if constexpr (S != kFwd) {
      load<V>(p.stats + c0, mu);
      load<V>(p.stats + p.C + c0, rs);
      load<V>(p.gamma + (size_t)b * p.C + c0, g);
      load<V>(p.beta + (size_t)b * p.C + c0, be);
    }
    const int r1 = min((slab + 1) * p.slab, p.Q);
    const size_t item = (size_t)b * p.Q;
#pragma unroll 4
    for (int r = slab * p.slab + warp; r < r1; r += kWarps) {
      const size_t off = (item + r) * p.C + c0;
      float xv[V];
      load<V>(p.x + off, xv);
      if constexpr (S == kFwd) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[0][j] += xv[j];
          acc[1][j] += xv[j] * xv[j];
        }
      } else {
        float gv[V], av[V];
        load<V>(p.gh + off, gv);
        if constexpr (S == kBwd2) load<V>(p.a + off, av);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = xhat(xv[j], mu[j], rs[j]);
          const float gz = live(zval(g[j], xh, be[j])) ? gv[j] : 0.f;
          acc[0][j] += gz;
          acc[1][j] += gz * xh;
          if constexpr (S == kBwd2) {
            acc[2][j] += av[j];
            acc[3][j] += av[j] * xh;
            acc[4][j] += av[j] * gz;
          }
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < V; ++j) sh[warp][s][lane * V + j] = acc[s][j];
  __syncthreads();
  const int nslab = gridDim.y;
  for (int t = threadIdx.x; t < NS * kLanes * V; t += kThreads) {
    const int s = t / (kLanes * V), col = t % (kLanes * V);
    const int c = blockIdx.x * kLanes * V + col;
    if (c < p.C) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sh[w][s][col];
      partial[(((size_t)b * nslab + slab) * NS + s) * p.C + c] = sum;
    }
  }
}

// Sums the partials of every item over its slabs, in slab order, into
// sums + (s·B + b)·C + c. A CTA: 32 channels, its warps over the slabs.
template <int NS>
__device__ void sum_slabs(const float* __restrict__ partial, float* __restrict__ sums, int B,
                          int nslab, int C) {
  __shared__ float sh[kWarps][NS][kLanes];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int c = blockIdx.x * kLanes + lane;
  for (int b = 0; b < B; ++b) {
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.f;
    if (c < C) {
      for (int sl = warp; sl < nslab; sl += kWarps) {
        const float* q = partial + ((size_t)b * nslab + sl) * NS * C + c;
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] += q[(size_t)s * C];
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) sh[warp][s][lane] = acc[s];
    __syncthreads();
    if (warp < NS && c < C) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += sh[w][warp][lane];
      sums[((size_t)warp * B + b) * C + c] = t;
    }
    __syncthreads();
  }
}

// sums: (2, B, C) scratch. Writes stats (μ, r, k) and moves the running buffers.
__global__ void __launch_bounds__(kThreads) finalize_fwd(
    const float* __restrict__ partial, float* __restrict__ sums, float* __restrict__ stats,
    float* __restrict__ run_mean, float* __restrict__ run_var, int B, int Q, int C, int nslab,
    float eps, float momentum) {
  sum_slabs<2>(partial, sums, B, nslab, C);
  const int c = blockIdx.x * kLanes + threadIdx.x;
  if (threadIdx.x >= kLanes || c >= C) return;
  float s0 = 0.f, s1 = 0.f;
  for (int b = 0; b < B; ++b) {
    s0 += sums[(size_t)b * C + c];
    s1 += sums[((size_t)B + b) * C + c];
  }
  const float M = (float)B * (float)Q;
  const float mu = s0 / M;
  const float d = __fsub_rn(s1 / M, __fmul_rn(mu, mu));
  const float v = fmaxf(d, 0.f);
  stats[c] = mu;
  stats[C + c] = 1.0f / sqrtf(__fadd_rn(v, eps));
  stats[2 * C + c] = d >= 0.f ? 1.f : 0.f;
  run_mean[c] = run_mean[c] * (1.f - momentum) + momentum * mu;
  run_var[c] = run_var[c] * (1.f - momentum) + momentum * v;
}

// sums: the (2, B, C) output gβ, gγ. Writes the pass's coef: S1/M, k·S2/M.
__global__ void __launch_bounds__(kThreads) finalize_bwd(
    const float* __restrict__ partial, float* __restrict__ sums, const float* __restrict__ gamma,
    const float* __restrict__ stats, float* __restrict__ coef, int B, int Q, int C, int nslab) {
  sum_slabs<2>(partial, sums, B, nslab, C);
  const int c = blockIdx.x * kLanes + threadIdx.x;
  if (threadIdx.x >= kLanes || c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int b = 0; b < B; ++b) {
    const float g = gamma[(size_t)b * C + c];
    s1 += g * sums[(size_t)b * C + c];
    s2 += g * sums[((size_t)B + b) * C + c];
  }
  const float M = (float)B * (float)Q;
  coef[c] = s1 / M;
  coef[C + c] = stats[2 * C + c] * s2 / M;
}

// sums: (5, B, C) scratch of Σgz, Σgz·x̂, Σa, Σa·x̂, Σa·gz per item. Writes
// gγ of the second derivative, pb (B, C) and coef (5, C): A/M, k·A2/M, q,
// G1/M, k·(r·R + G2)/M.
__global__ void __launch_bounds__(kThreads) finalize_bwd2(
    const float* __restrict__ partial, float* __restrict__ sums, const float* __restrict__ gamma,
    const float* __restrict__ ga, const float* __restrict__ stats, float* __restrict__ ggamma,
    float* __restrict__ pb, float* __restrict__ coef, int B, int Q, int C, int nslab) {
  sum_slabs<5>(partial, sums, B, nslab, C);
  const int c = blockIdx.x * kLanes + threadIdx.x;
  if (threadIdx.x >= kLanes || c >= C) return;
  const size_t BC = (size_t)B * C;
  const float* gb = sums;
  const float* gg = sums + BC;
  const float* sa = sums + 2 * BC;
  const float* sa2 = sums + 3 * BC;
  const float* st = sums + 4 * BC;
  float A = 0.f, A2 = 0.f, s1 = 0.f, s2 = 0.f, gt = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t i = (size_t)b * C + c;
    const float g = gamma[i];
    A += sa[i];
    A2 += sa2[i];
    s1 += g * gb[i];
    s2 += g * gg[i];
    gt += g * st[i];
  }
  const float M = (float)B * (float)Q;
  const float r = stats[C + c], k = stats[2 * C + c];
  const float e1 = A / M, e2 = k * A2 / M, q = k * r * s2 / M, kra = k * r / M * A2;
  float g1 = 0.f, g2 = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t i = (size_t)b * C + c;
    const float p = ga[i] - kra * gamma[i];
    pb[i] = p;
    g1 += p * gb[i];
    g2 += p * gg[i];
    ggamma[i] = r * (st[i] - gb[i] * e1 - gg[i] * e2);
  }
  g1 -= q * A;
  g2 -= q * A2;
  const float R = gt - s1 * A / M - k * s2 * A2 / M;
  coef[c] = e1;
  coef[C + c] = e2;
  coef[2 * C + c] = q;
  coef[3 * C + c] = g1 / M;
  coef[4 * C + c] = k * (r * R + g2) / M;
}

template <int S, int V>
__global__ void __launch_bounds__(kThreads) apply(Args p) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int c0 = (blockIdx.x * kLanes + lane) * V;
  if (c0 >= p.C) return;
  const int slab = blockIdx.y, b = blockIdx.z;
  const size_t bc = (size_t)b * p.C + c0;
  float mu[V], rs[V], g[V], be[V];
  load<V>(p.stats + c0, mu);
  load<V>(p.stats + p.C + c0, rs);
  load<V>(p.gamma + bc, g);
  load<V>(p.beta + bc, be);
  // backward: c1 = S1/M, c2 = k·S2/M; backward2: e1, e2, q, f1, f2, and
  // the item's Γ, Β and P
  float c1[V], c2[V], q[V], f1[V], f2[V], gam[V], bet[V], pv[V];
  if constexpr (S != kFwd) {
    load<V>(p.coef + c0, c1);
    load<V>(p.coef + p.C + c0, c2);
  }
  if constexpr (S == kBwd2) {
    load<V>(p.coef + 2 * p.C + c0, q);
    load<V>(p.coef + 3 * p.C + c0, f1);
    load<V>(p.coef + 4 * p.C + c0, f2);
    load<V>(p.ga + bc, gam);
    load<V>(p.ba + bc, bet);
    load<V>(p.pb + bc, pv);
  }
  const int r1 = min((slab + 1) * p.slab, p.Q);
  const size_t item = (size_t)b * p.Q;
#pragma unroll 4
  for (int r = slab * p.slab + warp; r < r1; r += kWarps) {
    const size_t off = (item + r) * p.C + c0;
    float xv[V], o0[V];
    load<V>(p.x + off, xv);
    if constexpr (S == kFwd) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float z = zval(g[j], xhat(xv[j], mu[j], rs[j]), be[j]);
        o0[j] = z < 0.f ? 0.f : z;  // relu; a NaN stays
      }
    } else if constexpr (S == kBwd) {
      float gv[V];
      load<V>(p.gh + off, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = xhat(xv[j], mu[j], rs[j]);
        const float gz = live(zval(g[j], xh, be[j])) ? gv[j] : 0.f;
        o0[j] = rs[j] * (g[j] * gz - c1[j] - c2[j] * xh);
      }
    } else {
      float gv[V], av[V], o1[V];
      load<V>(p.gh + off, gv);
      load<V>(p.a + off, av);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = xhat(xv[j], mu[j], rs[j]);
        const bool m = live(zval(g[j], xh, be[j]));
        const float gz = m ? gv[j] : 0.f;
        o0[j] = m ? g[j] * rs[j] * (av[j] - c1[j] - c2[j] * xh) + gam[j] * xh + bet[j] : 0.f;
        o1[j] = rs[j] * (pv[j] * gz - q[j] * av[j] - f1[j] - f2[j] * xh);
      }
      store<V>(p.out1 + off, o1);
    }
    store<V>(p.out0 + off, o0);
  }
}

template <int S>
int run(const Args& p, int B, int vec, float* partial, cudaStream_t stream) {
  const int V = vec ? 4 : 1;
  const dim3 grid((p.C / V + kLanes - 1) / kLanes, (p.Q + p.slab - 1) / p.slab, B);
  if (vec) reduce<S, 4><<<grid, kThreads, 0, stream>>>(p, partial);
  else reduce<S, 1><<<grid, kThreads, 0, stream>>>(p, partial);
  return (int)cudaGetLastError();
}

template <int S>
int run_apply(const Args& p, int B, int vec, cudaStream_t stream) {
  const int V = vec ? 4 : 1;
  const dim3 grid((p.C / V + kLanes - 1) / kLanes, (p.Q + p.slab - 1) / p.slab, B);
  if (vec) apply<S, 4><<<grid, kThreads, 0, stream>>>(p);
  else apply<S, 1><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

int nslabs(int Q, int slab) { return (Q + slab - 1) / slab; }

int finalize_grid(int C) { return (C + kLanes - 1) / kLanes; }

}  // namespace

// scratch: B·nslab·2·C partials, then (2, B, C) sums.
extern "C" int surfd_cbn_forward(const float* x, const float* gamma, const float* beta,
                                 float* run_mean, float* run_var, float* stats, float* h,
                                 float* scratch, int B, int Q, int C, int slab, int vec,
                                 float eps, float momentum, cudaStream_t stream) {
  Args p{x, nullptr, nullptr, gamma, beta, nullptr, nullptr, stats, nullptr, nullptr,
         h, nullptr, Q, C, slab};
  const int ns = nslabs(Q, slab);
  float* partial = scratch;
  float* sums = scratch + (size_t)B * ns * 2 * C;
  int rc = run<kFwd>(p, B, vec, partial, stream);
  if (rc) return rc;
  finalize_fwd<<<finalize_grid(C), kThreads, 0, stream>>>(partial, sums, stats, run_mean,
                                                          run_var, B, Q, C, ns, eps, momentum);
  if ((rc = (int)cudaGetLastError())) return rc;
  return run_apply<kFwd>(p, B, vec, stream);
}

// grads: (2, B, C) outputs, gβ then gγ; scratch: B·nslab·2·C partials, then
// (2, C) coef.
extern "C" int surfd_cbn_backward(const float* x, const float* gh, const float* gamma,
                                  const float* beta, const float* stats, float* gx,
                                  float* grads, float* scratch, int B, int Q, int C, int slab,
                                  int vec, cudaStream_t stream) {
  const int ns = nslabs(Q, slab);
  float* partial = scratch;
  float* coef = scratch + (size_t)B * ns * 2 * C;
  Args p{x, gh, nullptr, gamma, beta, nullptr, nullptr, stats, coef, nullptr,
         gx, nullptr, Q, C, slab};
  int rc = run<kBwd>(p, B, vec, partial, stream);
  if (rc) return rc;
  finalize_bwd<<<finalize_grid(C), kThreads, 0, stream>>>(partial, grads, gamma, stats, coef, B,
                                                          Q, C, ns);
  if ((rc = (int)cudaGetLastError())) return rc;
  return run_apply<kBwd>(p, B, vec, stream);
}

// scratch: B·nslab·5·C partials, (5, B, C) sums, (B, C) pb, (5, C) coef.
extern "C" int surfd_cbn_backward2(const float* x, const float* gh, const float* a,
                                   const float* gamma, const float* beta, const float* ga,
                                   const float* ba, const float* stats, float* ggh, float* gx,
                                   float* ggamma, float* scratch, int B, int Q, int C, int slab,
                                   int vec, cudaStream_t stream) {
  const int ns = nslabs(Q, slab);
  const size_t BC = (size_t)B * C;
  float* partial = scratch;
  float* sums = partial + (size_t)B * ns * 5 * C;
  float* pb = sums + 5 * BC;
  float* coef = pb + BC;
  Args p{x, gh, a, gamma, beta, ga, ba, stats, coef, pb, ggh, gx, Q, C, slab};
  int rc = run<kBwd2>(p, B, vec, partial, stream);
  if (rc) return rc;
  finalize_bwd2<<<finalize_grid(C), kThreads, 0, stream>>>(partial, sums, gamma, ga, stats,
                                                           ggamma, pb, coef, B, Q, C, ns);
  if ((rc = (int)cudaGetLastError())) return rc;
  return run_apply<kBwd2>(p, B, vec, stream);
}
