// The DGCNN encoder's train-mode edge convolution (gather → Linear →
// BatchNorm on the batch's statistics → LeakyReLU 0.2 → max over the k
// neighbours): forward and first derivative (ops/edgeconv_train.py gives the
// formulas and their plain versions).
//
// Replaces no TPU kernel: the JAX package left the DGCNN to XLA
// (surfd_tpu/models/dgcnn.py). The port composed it, each block writing and
// re-reading a dozen (B, N, k, ·) tensors a step (the gathered features,
// their difference and concatenation, the Linear's output, BatchNorm's
// intermediates, the max's masks and autograd's sums of all of them): at the
// AE step's 8 × 10,000 × 20 edges one such tensor of block 4 is 1.64 GB.
//
// What bounds it: the gathers. The Linear is taken at the point level
// (e_ij = P_j + Q_i, PQ = x·[W_a; W_b − W_a]ᵀ by the caller), so every pass
// here reads rows of PQ (2·Dout floats a point) by the neighbour indices;
// an item's rows are at most 10,000 × 2 KB, most of them L2-resident while
// the CTAs of nearby points run. Nothing of size B·N·k is written: the
// forward keeps per (point, channel) the extreme e over the neighbours and
// its slot, the backward sums each point's out-edges and in-edges.
//
// Threads: a point's row of Dout channels is L lanes of 4 channels (16-byte
// loads; Dout % 4 == 0), L = 8, 16 or 32, so a 256-thread CTA runs 256 / L
// points at a time and owns a slab of `slab` consecutive points (global ids
// g = b·N + i) and a tile of 4·L channels. Per-slab sums are combined in a
// fixed order through shared memory; the finalize kernels sum the slabs in a
// fixed order in double. No float atomics: two runs give the same bits.
//
// Launches: forward = edges, finalize_fwd, apply_fwd; backward =
// reduce_bwd, finalize_bwd, points_bwd.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSlope = 0.2f;  // the LeakyReLU's
constexpr int kFinLanes = 32;   // channels of a finalize CTA
constexpr int kFinWarps = kThreads / kFinLanes;

struct Shape {
  long long G;  // points, B·N
  int N, k, D, slab;
};

struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 ld4(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ void st4(float* p, const F4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

__device__ __forceinline__ uchar4 ldb4(const uint8_t* p) {
  return *reinterpret_cast<const uchar4*>(p);
}

__device__ __forceinline__ uint8_t byte(const uchar4& s, int j) {
  return j == 0 ? s.x : j == 1 ? s.y : j == 2 ? s.z : s.w;
}

__device__ __forceinline__ float lrelu(float y) { return y > 0.f ? y : __fmul_rn(y, kSlope); }

// Sums `acc` (NS values × 4 channels a thread) over the CTA's point rows in
// row order, and writes them to partial[(slab·NS + s)·D + c].
template <int L, int NS>
__device__ __forceinline__ void slab_sums(const float (&acc)[NS][4], float* __restrict__ partial,
                                          const Shape& s) {
  constexpr int R = kThreads / L;
  __shared__ float sh[NS][R][4 * L];
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) sh[n][row][4 * lane + j] = acc[n][j];
  __syncthreads();
  for (int t = threadIdx.x; t < NS * 4 * L; t += kThreads) {
    const int n = t / (4 * L), col = t % (4 * L);
    const int c = blockIdx.x * 4 * L + col;
    if (c < s.D) {
      float sum = 0.f;
      for (int r = 0; r < R; ++r) sum += sh[n][r][col];
      partial[((size_t)blockIdx.y * NS + n) * s.D + c] = sum;
    }
  }
}

// Per (point, channel): the largest and the smallest e_ij = P_j + Q_i over
// the neighbours, with their first slots (a NaN is kept once met, as amax
// keeps it); per slab: Σe, Σe².
template <int L>
__global__ void __launch_bounds__(kThreads) edges(
    const float* __restrict__ pq, const int* __restrict__ idx, float* __restrict__ emax,
    float* __restrict__ emin, uint8_t* __restrict__ smax, uint8_t* __restrict__ smin,
    float* __restrict__ partial, Shape s) {
  constexpr int R = kThreads / L;
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int c0 = (blockIdx.x * L + lane) * 4;
  const int ld = 2 * s.D;
  float acc[2][4] = {};
  if (c0 < s.D) {
    const long long g0 = (long long)blockIdx.y * s.slab;
    const long long g1 = min(g0 + s.slab, s.G);
    for (long long g = g0 + row; g < g1; g += R) {
      const long long base = g / s.N * s.N;
      const F4 q = ld4(pq + g * ld + s.D + c0);
      const int* nb = idx + g * s.k;
      float mx[4], mn[4];
      int ax[4], an[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx[j] = -INFINITY;
        mn[j] = INFINITY;
        ax[j] = an[j] = 0;
      }
#pragma unroll 4
      for (int t = 0; t < s.k; ++t) {
        const F4 p = ld4(pq + (base + nb[t]) * ld + c0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = __fadd_rn(p.v[j], q.v[j]);
          acc[0][j] += e;
          acc[1][j] = fmaf(e, e, acc[1][j]);
          const bool nan = e != e;
          if (e > mx[j] || (nan && mx[j] == mx[j])) { mx[j] = e; ax[j] = t; }
          if (e < mn[j] || (nan && mn[j] == mn[j])) { mn[j] = e; an[j] = t; }
        }
      }
      const size_t o = (size_t)g * s.D + c0;
      st4(emax + o, {{mx[0], mx[1], mx[2], mx[3]}});
      st4(emin + o, {{mn[0], mn[1], mn[2], mn[3]}});
      *reinterpret_cast<uchar4*>(smax + o) =
          make_uchar4((uint8_t)ax[0], (uint8_t)ax[1], (uint8_t)ax[2], (uint8_t)ax[3]);
      *reinterpret_cast<uchar4*>(smin + o) =
          make_uchar4((uint8_t)an[0], (uint8_t)an[1], (uint8_t)an[2], (uint8_t)an[3]);
    }
  }
  slab_sums<L, 2>(acc, partial, s);
}

// The two per-slab sums of channel c over the slabs, in slab order by warps
// and the warps in order, in double; valid in warp 0.
__device__ __forceinline__ void sum_slabs(const float* __restrict__ partial, int nslab, int D,
                                          int c, double& s0, double& s1) {
  __shared__ double sh[2][kFinWarps][kFinLanes];
  const int lane = threadIdx.x % kFinLanes, warp = threadIdx.x / kFinLanes;
  double a0 = 0.0, a1 = 0.0;
  if (c < D) {
    for (int sl = warp; sl < nslab; sl += kFinWarps) {
      a0 += partial[(size_t)sl * 2 * D + c];
      a1 += partial[((size_t)sl * 2 + 1) * D + c];
    }
  }
  sh[0][warp][lane] = a0;
  sh[1][warp][lane] = a1;
  __syncthreads();
  s0 = s1 = 0.0;
  if (warp == 0) {
    for (int w = 0; w < kFinWarps; ++w) {
      s0 += sh[0][w][lane];
      s1 += sh[1][w][lane];
    }
  }
}

// stats (4, D): μ, r, mul = r·γ, the clamp's mask k; moves the running buffers.
__global__ void __launch_bounds__(kThreads) finalize_fwd(
    const float* __restrict__ partial, const float* __restrict__ gamma,
    float* __restrict__ stats, float* __restrict__ run_mean, float* __restrict__ run_var,
    int nslab, int D, double M, float eps, float momentum) {
  const int c = blockIdx.x * kFinLanes + threadIdx.x % kFinLanes;
  double s0, s1;
  sum_slabs(partial, nslab, D, c, s0, s1);
  if (threadIdx.x >= kFinLanes || c >= D) return;
  const double mean = s0 / M;
  const float mu = (float)mean;
  const float d = (float)(s1 / M - mean * mean);
  const float v = fmaxf(d, 0.f);
  const float r = 1.0f / sqrtf(__fadd_rn(v, eps));
  stats[c] = mu;
  stats[D + c] = r;
  stats[2 * D + c] = __fmul_rn(r, gamma[c]);
  stats[3 * D + c] = d >= 0.f ? 1.f : 0.f;
  run_mean[c] = run_mean[c] * (1.f - momentum) + momentum * mu;
  run_var[c] = run_var[c] * (1.f - momentum) + momentum * v;
}

// f = lrelu((e_sel − μ)·mul + β), e_sel the max where mul ≥ 0 (or NaN), else
// the min; e_sel and its slot overwrite emax and smax.
template <int L>
__global__ void __launch_bounds__(kThreads) apply_fwd(
    const float* __restrict__ stats, const float* __restrict__ beta, float* __restrict__ emax,
    const float* __restrict__ emin, uint8_t* __restrict__ smax, const uint8_t* __restrict__ smin,
    float* __restrict__ f, Shape s) {
  constexpr int R = kThreads / L;
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int c0 = (blockIdx.x * L + lane) * 4;
  if (c0 >= s.D) return;
  const F4 mu = ld4(stats + c0), mul = ld4(stats + 2 * s.D + c0), be = ld4(beta + c0);
  const long long g0 = (long long)blockIdx.y * s.slab;
  const long long g1 = min(g0 + s.slab, s.G);
  for (long long g = g0 + row; g < g1; g += R) {
    const size_t o = (size_t)g * s.D + c0;
    const F4 hi = ld4(emax + o), lo = ld4(emin + o);
    const uchar4 shi = ldb4(smax + o), slo = ldb4(smin + o);
    F4 e, out;
    uint8_t sl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool up = !(mul.v[j] < 0.f);
      e.v[j] = up ? hi.v[j] : lo.v[j];
      sl[j] = up ? byte(shi, j) : byte(slo, j);
      out.v[j] = lrelu(__fadd_rn(__fmul_rn(__fsub_rn(e.v[j], mu.v[j]), mul.v[j]), be.v[j]));
    }
    st4(f + o, out);
    st4(emax + o, e);
    *reinterpret_cast<uchar4*>(smax + o) = make_uchar4(sl[0], sl[1], sl[2], sl[3]);
  }
}

// u = ∂L/∂f · lrelu'(f); per slab Σu and Σu·x̂_sel.
template <int L>
__global__ void __launch_bounds__(kThreads) reduce_bwd(
    const float* __restrict__ gf, const float* __restrict__ f, const float* __restrict__ esel,
    const float* __restrict__ stats, float* __restrict__ u, float* __restrict__ partial,
    Shape s) {
  constexpr int R = kThreads / L;
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int c0 = (blockIdx.x * L + lane) * 4;
  float acc[2][4] = {};
  if (c0 < s.D) {
    const F4 mu = ld4(stats + c0), rs = ld4(stats + s.D + c0);
    const long long g0 = (long long)blockIdx.y * s.slab;
    const long long g1 = min(g0 + s.slab, s.G);
    for (long long g = g0 + row; g < g1; g += R) {
      const size_t o = (size_t)g * s.D + c0;
      const F4 gv = ld4(gf + o), fv = ld4(f + o), ev = ld4(esel + o);
      F4 uv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uv.v[j] = fv.v[j] > 0.f ? gv.v[j] : __fmul_rn(gv.v[j], kSlope);
        acc[0][j] += uv.v[j];
        acc[1][j] += uv.v[j] * __fmul_rn(__fsub_rn(ev.v[j], mu.v[j]), rs.v[j]);
      }
      st4(u + o, uv);
    }
  }
  slab_sums<L, 2>(acc, partial, s);
}

// grads (2, D): ∂β = Su, ∂γ = Sux; coef (4, D): mul, Su/M, r·k·Sux/M, μ.
__global__ void __launch_bounds__(kThreads) finalize_bwd(
    const float* __restrict__ partial, const float* __restrict__ stats,
    float* __restrict__ grads, float* __restrict__ coef, int nslab, int D, double M) {
  const int c = blockIdx.x * kFinLanes + threadIdx.x % kFinLanes;
  double su, sux;
  sum_slabs(partial, nslab, D, c, su, sux);
  if (threadIdx.x >= kFinLanes || c >= D) return;
  grads[c] = (float)su;
  grads[D + c] = (float)sux;
  coef[c] = stats[2 * D + c];
  coef[D + c] = (float)(su / M);
  coef[2 * D + c] = (float)((double)stats[D + c] * stats[3 * D + c] * sux / M);
  coef[3 * D + c] = stats[c];
}

// Per point g and channel: Gc = Σ over g's out-edges of G, Gn = Σ over its
// in-edges (the reverse adjacency, in ascending edge order); h[g] = [Gn − Gc,
// Gc], with G_ij = mul·(s_ij·u_i − Su/M − (e_ij − μ)·r·k·Sux/M).
template <int L>
__global__ void __launch_bounds__(kThreads) points_bwd(
    const float* __restrict__ pq, const int* __restrict__ idx, const int* __restrict__ offsets,
    const int* __restrict__ rev, const float* __restrict__ u, const uint8_t* __restrict__ sel,
    const float* __restrict__ coef, float* __restrict__ h, Shape s) {
  constexpr int R = kThreads / L;
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  const int c0 = (blockIdx.x * L + lane) * 4;
  if (c0 >= s.D) return;
  const int ld = 2 * s.D;
  const F4 mul = ld4(coef + c0), a1 = ld4(coef + s.D + c0), a2 = ld4(coef + 2 * s.D + c0);
  const F4 mu = ld4(coef + 3 * s.D + c0);
  const long long g0 = (long long)blockIdx.y * s.slab;
  const long long g1 = min(g0 + s.slab, s.G);
  for (long long g = g0 + row; g < g1; g += R) {
    const long long base = g / s.N * s.N;
    const F4 pj = ld4(pq + g * ld + c0), qj = ld4(pq + g * ld + s.D + c0);
    const F4 uj = ld4(u + (size_t)g * s.D + c0);
    float sc[4] = {}, ss[4] = {}, se[4] = {};
    const int* nb = idx + g * s.k;
#pragma unroll 4
    for (int t = 0; t < s.k; ++t) {
      const F4 p = ld4(pq + (base + nb[t]) * ld + c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] += __fsub_rn(__fadd_rn(p.v[j], qj.v[j]), mu.v[j]);
    }
    const int e0 = offsets[g], e1 = offsets[g + 1];
#pragma unroll 2
    for (int t = e0; t < e1; ++t) {
      const int eid = rev[t];
      const int i = eid / s.k, slot = eid - i * s.k;
      const F4 qi = ld4(pq + (size_t)i * ld + s.D + c0);
      const F4 ui = ld4(u + (size_t)i * s.D + c0);
      const uchar4 si = ldb4(sel + (size_t)i * s.D + c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ss[j] += byte(si, j) == slot ? ui.v[j] : 0.f;
        se[j] += __fsub_rn(__fadd_rn(pj.v[j], qi.v[j]), mu.v[j]);
      }
    }
    const float deg = (float)(e1 - e0), kk = (float)s.k;
    F4 gn_gc, gc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gc.v[j] = mul.v[j] * (uj.v[j] - kk * a1.v[j] - a2.v[j] * sc[j]);
      const float gn = mul.v[j] * (ss[j] - deg * a1.v[j] - a2.v[j] * se[j]);
      gn_gc.v[j] = gn - gc.v[j];
    }
    st4(h + (size_t)g * ld + c0, gn_gc);
    st4(h + (size_t)g * ld + s.D + c0, gc);
  }
}

int lanes(int D) { return D <= 32 ? 8 : D <= 64 ? 16 : 32; }

dim3 grid(const Shape& s, int L) {
  return dim3((s.D / 4 + L - 1) / L, (unsigned)((s.G + s.slab - 1) / s.slab));
}

template <template <int> class K, typename... A>
int launch(const Shape& s, cudaStream_t stream, A... args) {
  const int L = lanes(s.D);
  if (L == 8) K<8>::run(grid(s, 8), stream, args...);
  else if (L == 16) K<16>::run(grid(s, 16), stream, args...);
  else K<32>::run(grid(s, 32), stream, args...);
  return (int)cudaGetLastError();
}

#define SURFD_EDGECONV_LAUNCHER(NAME)                                    \
  template <int L>                                                       \
  struct NAME##_k {                                                      \
    template <typename... A>                                             \
    static void run(dim3 g, cudaStream_t st, A... a) {                   \
      NAME<L><<<g, kThreads, 0, st>>>(a...);                             \
    }                                                                    \
  };

SURFD_EDGECONV_LAUNCHER(edges)
SURFD_EDGECONV_LAUNCHER(apply_fwd)
SURFD_EDGECONV_LAUNCHER(reduce_bwd)
SURFD_EDGECONV_LAUNCHER(points_bwd)

int nslabs(const Shape& s) { return (int)((s.G + s.slab - 1) / s.slab); }

unsigned finalize_grid(int D) { return (D + kFinLanes - 1) / kFinLanes; }

}  // namespace

// pq (B·N, 2·D) = [P | Q]; idx (B, N, k) int32; f, esel, emin (B·N, D);
// sel, smin (B·N, D) uint8; partial: nslab·2·D; stats (4, D) out.
extern "C" int surfd_edgeconv_forward(const float* pq, const int* idx, const float* gamma,
                                      const float* beta, float* run_mean, float* run_var,
                                      float* stats, float* f, float* esel, float* emin,
                                      uint8_t* sel, uint8_t* smin, float* partial, int B, int N,
                                      int k, int D, int slab, float eps, float momentum,
                                      cudaStream_t stream) {
  const Shape s{(long long)B * N, N, k, D, slab};
  int rc = launch<edges_k>(s, stream, pq, idx, esel, emin, sel, smin, partial, s);
  if (rc) return rc;
  const double M = (double)B * N * k;
  finalize_fwd<<<finalize_grid(D), kThreads, 0, stream>>>(partial, gamma, stats, run_mean,
                                                          run_var, nslabs(s), D, M, eps,
                                                          momentum);
  if ((rc = (int)cudaGetLastError())) return rc;
  return launch<apply_fwd_k>(s, stream, (const float*)stats, beta, esel, (const float*)emin,
                             sel, (const uint8_t*)smin, f, s);
}

// gf, f, esel (B·N, D), sel uint8, stats (4, D) from the forward; pq, idx;
// the reverse adjacency offsets (B·N + 1), rev (B·N·k); u (B·N, D) and h
// (B·N, 2·D) out, grads (2, D) out (∂β, ∂γ), coef (4, D) and partial
// (nslab·2·D) scratch.
extern "C" int surfd_edgeconv_backward(const float* gf, const float* f, const float* esel,
                                       const uint8_t* sel, const float* stats, const float* pq,
                                       const int* idx, const int* offsets, const int* rev,
                                       float* u, float* h, float* grads, float* coef,
                                       float* partial, int B, int N, int k, int D, int slab,
                                       cudaStream_t stream) {
  const Shape s{(long long)B * N, N, k, D, slab};
  int rc = launch<reduce_bwd_k>(s, stream, gf, f, esel, stats, u, partial, s);
  if (rc) return rc;
  const double M = (double)B * N * k;
  finalize_bwd<<<finalize_grid(D), kThreads, 0, stream>>>(partial, stats, grads, coef,
                                                          nslabs(s), D, M);
  if ((rc = (int)cudaGetLastError())) return rc;
  return launch<points_bwd_k>(s, stream, pq, idx, offsets, rev, (const float*)u, sel,
                              (const float*)coef, h, s);
}
