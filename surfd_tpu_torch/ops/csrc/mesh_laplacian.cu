// Uniform Laplacian smoothing of a triangle mesh: `iterations` Jacobi steps
// v <- v + lam * (mean(neighbours) - v), the cleanup's last-but-one pass.
//
// Replaces no TPU kernel: the JAX package smooths on the host in float64
// numpy (surfd_tpu/geometry/mesh_ops.py:184-200, `laplacian_smooth`), and so
// did the port until this kernel. The neighbours are numpy's multiset of
// directed edges: for each corner (face f, slot c) of a vertex, the face's
// vertices at slots (c+1)%3 and (c+2)%3, so a neighbour shared by two faces
// counts twice, as does a repeated id of a degenerate face. A vertex in no
// face stays where it is.
//
// What bounds it on an H100: bytes. A pass does a few integer operations and
// six float64 adds per corner. At 256^3 (~850k vertices, ~1.7M faces) a pass
// reads the row offsets (3.4 MB), the corner lists (20 MB), the corners'
// vertex ids (20 MB) and the float64 positions (20 MB), mostly from the 50 MB
// L2, and writes 20 MB. The call as a whole is bound by the PCIe copies
// around it (~50 MB up, ~10 MB down), not by this file.
//
// Design:
// - Corner adjacency once a call, on the card: count the corners of each
//   vertex (narrowing the int64 faces to int32 on the way), an exclusive
//   scan into row offsets (tiles of 4096 scanned by warp shuffles, then the
//   tiles' sums, then the sums added), a fill by atomics, and each row
//   sorted by corner id: the atomics' order varies, the sorted rows do not,
//   so two calls are bit-equal.
// - One thread per vertex a pass, reading its row. It sums in numpy's order:
//   np.bincount walks the edge array [f01, f12, f20, f10, f21, f02], so a
//   vertex gets its (c+1) neighbours slot 0, 1, 2 in face order, then its
//   (c+2) neighbours slot 1, 2, 0 in face order. The row, sorted by corner
//   id, is in face order; the thread walks it six times, once per slot and
//   step. The sums, the division and the step use the _rn intrinsics, so
//   nothing is contracted into an FMA: the result is numpy's, bit for bit.
// - Positions are read as float32 by the first pass, ping-pong between two
//   float64 buffers and are written as float32 by the last pass.
// - Vertex ids outside [0, V) set a flag for the caller and are read as 0,
//   so that no access leaves the buffers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr unsigned kFull = 0xffffffffu;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// Corners per vertex; the faces' ids narrowed to int32.
__global__ void count_corners(const long long* __restrict__ faces, long long n_corners,
                              long long V, int* __restrict__ fi, int* __restrict__ cnt,
                              int* __restrict__ bad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_corners) return;
  long long v = faces[i];
  if (v < 0 || v >= V) {
    *bad = 1;
    v = 0;
  }
  fi[i] = (int)v;
  atomicAdd(&cnt[v], 1);
}

// Exclusive scan of x over the block's threads; the block's total in *total.
__device__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int n = blockDim.x >> 5;
    int s = lane < n ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < n) warp_sums[lane] = s;  // inclusive over warps
    if (lane == n - 1) *total = s;
  }
  __syncthreads();
  return inc - x + (warp ? warp_sums[warp - 1] : 0);
}

// Each tile of kScanTile counts: its exclusive scan into off, its sum into
// tile_sums.
__global__ void __launch_bounds__(kScanThreads) scan_tiles(const int* __restrict__ cnt,
                                                            long long V, int* __restrict__ off,
                                                            int* __restrict__ tile_sums) {
  __shared__ int warp_sums[32];
  __shared__ int total;
  const long long base = (long long)blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int x[kScanItems], s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    x[j] = base + j < V ? cnt[base + j] : 0;
    s += x[j];
  }
  int run = block_exclusive_scan(s, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (base + j < V) off[base + j] = run;
    run += x[j];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// The tiles' sums scanned in place (exclusive), by one block, a carry
// between its rounds.
__global__ void __launch_bounds__(kScanThreads) scan_tile_sums(int* __restrict__ sums,
                                                                int n_tiles) {
  __shared__ int warp_sums[32];
  __shared__ int total;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int x = i < n_tiles ? sums[i] : 0;
    const int ex = block_exclusive_scan(x, warp_sums, &total);
    if (i < n_tiles) sums[i] = carry + ex;
    carry += total;
    __syncthreads();  // warp_sums and total are rewritten by the next round
  }
}

// off[v] += its tile's offset; off[V] = the corner count.
__global__ void add_tile_offsets(int* __restrict__ off, const int* __restrict__ tile_sums,
                                 long long V, int n_corners) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v < V) off[v] += tile_sums[v / kScanTile];
  if (v == 0) off[V] = n_corners;
}

// Corner i into its vertex's row, at a slot taken by counting cnt back to 0.
__global__ void fill_rows(const int* __restrict__ fi, long long n_corners,
                          const int* __restrict__ off, int* __restrict__ cnt,
                          int* __restrict__ corners) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_corners) return;
  const int v = fi[i];
  corners[off[v] + atomicSub(&cnt[v], 1) - 1] = (int)i;
}

// Each row in ascending corner id (insertion sort: rows hold a vertex's
// faces, about six).
__global__ void sort_rows(const int* __restrict__ off, long long V, int* __restrict__ corners) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const int s = off[v], e = off[v + 1];
  for (int k = s + 1; k < e; ++k) {
    const int x = corners[k];
    int j = k - 1;
    while (j >= s && corners[j] > x) {
      corners[j + 1] = corners[j];
      --j;
    }
    corners[j + 1] = x;
  }
}

template <typename T>
__device__ __forceinline__ double ld(const T* p, long long i) {
  return (double)p[i];
}

template <typename T>
__device__ __forceinline__ void st(T* p, long long i, double x);
template <>
__device__ __forceinline__ void st<double>(double* p, long long i, double x) {
  p[i] = x;
}
template <>
__device__ __forceinline__ void st<float>(float* p, long long i, double x) {
  p[i] = __double2float_rn(x);
}

// One Jacobi step, a thread per vertex.
template <typename TIn, typename TOut>
__global__ void smooth_pass(const TIn* __restrict__ p, const int* __restrict__ off,
                            const int* __restrict__ corners, const int* __restrict__ fi,
                            long long V, double lam, TOut* __restrict__ out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const int s = off[v], e = off[v + 1];
  double sx = 0.0, sy = 0.0, sz = 0.0;
  // numpy's order: the (c+1) neighbours of slots 0, 1, 2, then the (c+2)
  // neighbours of slots 1, 2, 0, each in face order
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const int slot = r < 3 ? r : (r - 2) % 3, step = r < 3 ? 1 : 2;
    for (int k = s; k < e; ++k) {
      const int c = corners[k], f = c / 3, cs = c - 3 * f;
      if (cs != slot) continue;
      const long long n = fi[3 * f + (cs + step) % 3];
      sx = __dadd_rn(sx, ld(p, 3 * n));
      sy = __dadd_rn(sy, ld(p, 3 * n + 1));
      sz = __dadd_rn(sz, ld(p, 3 * n + 2));
    }
  }
  const double x = ld(p, 3 * v), y = ld(p, 3 * v + 1), z = ld(p, 3 * v + 2);
  double mx = x, my = y, mz = z;
  if (e > s) {
    const double count = 2.0 * (e - s);
    mx = __ddiv_rn(sx, count);
    my = __ddiv_rn(sy, count);
    mz = __ddiv_rn(sz, count);
  }
  st(out, 3 * v, __dadd_rn(x, __dmul_rn(lam, __dsub_rn(mx, x))));
  st(out, 3 * v + 1, __dadd_rn(y, __dmul_rn(lam, __dsub_rn(my, y))));
  st(out, 3 * v + 2, __dadd_rn(z, __dmul_rn(lam, __dsub_rn(mz, z))));
}

#define SURFD_CHECK(call)                      \
  do {                                         \
    cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// vertices (V, 3) f32 and faces (F, 3) int64 in; out (V, 3) f32. Scratch,
// allocated by the caller: fi and corners int32[3F], cnt int32[V], off
// int32[V + 1], tile_sums int32[ceil(V / 4096)], buf0 and buf1 f64[3V], bad
// one int32 (set to 1 where a face holds an id outside [0, V)). V < 2^31 and
// 3F < 2^31. Runs on `stream` and does not synchronise.
extern "C" int surfd_mesh_laplacian(const void* vertices, const void* faces, long long V,
                                    long long F, int iterations, double lam, void* out,
                                    void* fi, void* cnt, void* off, void* tile_sums,
                                    void* corners, void* buf0, void* buf1, void* bad,
                                    void* stream) {
  if (V <= 0 || iterations <= 0) return 0;
  if (V >= (1LL << 31) || F < 0 || 3 * F >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_corners = 3 * F;
  int *fi_ = (int*)fi, *cnt_ = (int*)cnt, *off_ = (int*)off, *sums_ = (int*)tile_sums;
  int *corners_ = (int*)corners, *bad_ = (int*)bad;
  const int n_tiles = (int)((V + kScanTile - 1) / kScanTile);

  SURFD_CHECK(cudaMemsetAsync(cnt_, 0, V * sizeof(int), st));
  SURFD_CHECK(cudaMemsetAsync(bad_, 0, sizeof(int), st));
  if (n_corners) {
    count_corners<<<blocks_for(n_corners), kThreads, 0, st>>>(
        (const long long*)faces, n_corners, V, fi_, cnt_, bad_);
    SURFD_CHECK(cudaGetLastError());
  }
  scan_tiles<<<n_tiles, kScanThreads, 0, st>>>(cnt_, V, off_, sums_);
  SURFD_CHECK(cudaGetLastError());
  scan_tile_sums<<<1, kScanThreads, 0, st>>>(sums_, n_tiles);
  SURFD_CHECK(cudaGetLastError());
  add_tile_offsets<<<blocks_for(V), kThreads, 0, st>>>(off_, sums_, V, (int)n_corners);
  SURFD_CHECK(cudaGetLastError());
  if (n_corners) {
    fill_rows<<<blocks_for(n_corners), kThreads, 0, st>>>(fi_, n_corners, off_, cnt_, corners_);
    SURFD_CHECK(cudaGetLastError());
    sort_rows<<<blocks_for(V), kThreads, 0, st>>>(off_, V, corners_);
    SURFD_CHECK(cudaGetLastError());
  }

  const float* in = (const float*)vertices;
  float* res = (float*)out;
  double* bufs[2] = {(double*)buf0, (double*)buf1};
  const int grid = blocks_for(V);
  for (int it = 0; it < iterations; ++it) {
    const bool first = it == 0, last = it == iterations - 1;
    const double* src = bufs[(it + 1) & 1];  // the previous pass's output
    double* dst = bufs[it & 1];
    if (first && last) {
      smooth_pass<float, float><<<grid, kThreads, 0, st>>>(in, off_, corners_, fi_, V, lam, res);
    } else if (first) {
      smooth_pass<float, double><<<grid, kThreads, 0, st>>>(in, off_, corners_, fi_, V, lam, dst);
    } else if (last) {
      smooth_pass<double, float><<<grid, kThreads, 0, st>>>(src, off_, corners_, fi_, V, lam, res);
    } else {
      smooth_pass<double, double><<<grid, kThreads, 0, st>>>(src, off_, corners_, fi_, V, lam,
                                                              dst);
    }
    SURFD_CHECK(cudaGetLastError());
  }
  return 0;
}
