// Dense M from overlapping Gram slabs: M[i, j] = sum over b of
// g_b[i - lo_b, j - lo_b], for every slab b whose window [lo_b, lo_b + H)
// holds both i and j, added in ascending b from 0.
//
// Replaces no TPU kernel.  It was added for the range-blocked FSAI setup
// on a per-case plan (ops/fsai.py::range_m_from_strips, windows without
// static starts), where PyTorch ran the assembly as
// index_put_(accumulate=True): a radix sort of the 2 097 152 linear
// indices (B 128 slabs of 128 x 128 into a 1024^2 M) and a kernel that
// sums each run of duplicates, ~0.36-0.48 ms a call on an H100 against a
// byte bound of ~3.8 us.  The order of the sums is the JAX reference's
// (its loop of slab adds) and the plain version's, so the kernel gives the
// plain version's bits: additions only, no contraction, and 0 + x = x.
//
// What bounds it on an H100 (3350 GB/s): bytes.  A call reads g once
// (B H^2 elements) and lo (B int64) and writes M once (n_pad^2): at the
// per-case shape (B 128, H 128, n_pad 1024, float32) 12.6 MB, 3.76 us.
// The adds (B H^2) are nothing beside that.
//
// Design: output-centric, so no sort, no atomics and no host sync; the
// launch is deterministic and can be captured in a CUDA graph.  A block of
// 256 threads owns one tile of M, 32 rows x 128 columns, and writes every
// entry of it, zeros off the windows included (so M needs no fill first).
// Warp 0 scans the window starts in ascending b, 32 at a time with a
// ballot, and stages the starts of the slabs whose window meets the tile
// in shared memory, in order (at most kList a pass).  Warp w then walks
// them for rows w, w + 8, w + 16, w + 24 of the tile, each lane for 4
// adjacent columns: it loads 4 entries of g_b a row (one 16-byte load
// where the window is aligned to 4 and holds all 4 columns, else 4 guarded
// loads; zero outside the window) and adds them, two slabs' loads in
// flight before their adds; at the end it stores the 4 sums of each row
// with 16-byte stores.  Adding the zero of a column outside a window
// leaves the sum's bits as they were (the sum starts at +0 and is never
// -0).  Every start is checked on the device, 0 <= lo_b <= n_pad - H, at
// every launch (replays of a graph included): a start out of range fails
// the launch with a device-side assert.
//
// At the per-case shape 88 of the 256 tiles meet a window, 12.5 slabs of
// the 128 on average; the tiles on the tail's first rows meet 31 (the last
// 16 windows all start at 896) and walk the longest chains of loads.  On
// an H100: 0.018-0.020 ms kernel only (0.18-0.21 of the bound; float64
// 0.021 ms, 0.35-0.36), against 0.82-0.92 ms a call for
// index_put_(accumulate=True).
//
// Layout: g (B, H, H) row-major, lo (B,) int64, M (n_pad, n_pad)
// row-major, all on one device; float32 or float64 (g and M of one dtype);
// g and M 16-byte aligned, n_pad a multiple of 4, 1 <= H <= n_pad.

#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;       // tile rows
constexpr int kCols = 128;      // tile columns: 32 lanes x 4
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 4
constexpr int kList = 256;      // slabs staged a pass

template <typename S>
struct Quad {
  S v[4];
};

// 4 adjacent entries from a 16-byte aligned address.
__device__ __forceinline__ Quad<float> load_quad(const float* p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  return {{x.x, x.y, x.z, x.w}};
}

__device__ __forceinline__ Quad<double> load_quad(const double* p) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {{x.x, x.y, y.x, y.y}};
}

__device__ __forceinline__ void store_quad(float* p, const Quad<float>& q) {
  *reinterpret_cast<float4*>(p) = make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
}

__device__ __forceinline__ void store_quad(double* p, const Quad<double>& q) {
  reinterpret_cast<double2*>(p)[0] = make_double2(q.v[0], q.v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(q.v[2], q.v[3]);
}

// Row i's columns j0 .. j0 + 3 of slab g_b (window start l): the entries
// inside the window, zero outside it.
template <typename S>
__device__ __forceinline__ Quad<S> slab_quad(const S* __restrict__ g,
                                             long long slab, int l, int h,
                                             int i, int j0) {
  Quad<S> q = {{S(0), S(0), S(0), S(0)}};
  const int r = i - l;
  if (r < 0 || r >= h) {
    return q;
  }
  const S* row = g + slab + static_cast<long long>(r) * h;
  if (((l | h) & 3) == 0 && j0 >= l && j0 + 3 < l + h) {
    return load_quad(row + (j0 - l));
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + c;
    if (j >= l && j < l + h) {
      q.v[c] = __ldg(row + (j - l));
    }
  }
  return q;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
gram_assembly_kernel(const S* __restrict__ g,
                     const long long* __restrict__ lo, S* __restrict__ m,
                     int nb, int h, int n_pad) {
  __shared__ int list_b[kList];
  __shared__ int list_lo[kList];
  __shared__ int list_count;
  __shared__ int list_next;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  const int r_end = min(r0 + kRows, n_pad);
  const int c_end = min(c0 + kCols, n_pad);
  const int j0 = c0 + 4 * lane;
  const long long slab_size = static_cast<long long>(h) * h;

  Quad<S> acc[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    acc[k] = {{S(0), S(0), S(0), S(0)}};
  }

  int next = 0;
  while (next < nb) {
    if (warp == 0) {
      int count = 0;
      int b = next;
      while (b < nb && count + 32 <= kList) {
        const int mine = b + lane;
        int l = 0;
        bool meets = false;
        if (mine < nb) {
          const long long start = lo[mine];
          assert(start >= 0 && start <= n_pad - h);
          l = static_cast<int>(start);
          meets = l < r_end && l + h > r0 && l < c_end && l + h > c0;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, meets);
        if (meets) {
          const int at = count + __popc(ballot & ((1u << lane) - 1u));
          list_b[at] = mine;
          list_lo[at] = l;
        }
        count += __popc(ballot);
        b += 32;
      }
      if (lane == 0) {
        list_count = count;
        list_next = b;
      }
    }
    __syncthreads();
    const int count = list_count;
    next = list_next;
    int t = 0;
    // two slabs' loads in flight, then their adds in ascending b
    for (; t + 1 < count; t += 2) {
      const long long s0 = list_b[t] * slab_size;
      const long long s1 = list_b[t + 1] * slab_size;
      const int l0 = list_lo[t];
      const int l1 = list_lo[t + 1];
      Quad<S> v0[kRowsPerWarp];
      Quad<S> v1[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int i = r0 + warp + kWarps * k;
        v0[k] = slab_quad(g, s0, l0, h, i, j0);
        v1[k] = slab_quad(g, s1, l1, h, i, j0);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[k].v[c] += v0[k].v[c];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[k].v[c] += v1[k].v[c];
        }
      }
    }
    if (t < count) {
      const long long s0 = list_b[t] * slab_size;
      const int l0 = list_lo[t];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int i = r0 + warp + kWarps * k;
        const Quad<S> v = slab_quad(g, s0, l0, h, i, j0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[k].v[c] += v.v[c];
        }
      }
    }
    __syncthreads();  // the list is rewritten by the next pass
  }

  if (j0 >= c_end) {
    return;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int i = r0 + warp + kWarps * k;
    if (i < r_end) {
      store_quad(m + static_cast<long long>(i) * n_pad + j0, acc[k]);
    }
  }
}

template <typename S>
int launch(const void* g, const void* lo, void* m, int nb, int h, int n_pad,
           void* stream) {
  if (nb < 1 || h < 1 || h > n_pad || n_pad % 4 != 0 ||
      (n_pad + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_pad + kCols - 1) / kCols, (n_pad + kRows - 1) / kRows);
  gram_assembly_kernel<S><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(g), static_cast<const long long*>(lo),
      static_cast<S*>(m), nb, h, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (nb, h, h), lo (nb,) int64, m (n_pad, n_pad): see the header.
extern "C" int dp_gram_assembly_f32(const void* g, const void* lo, void* m,
                                    int nb, int h, int n_pad, void* stream) {
  return launch<float>(g, lo, m, nb, h, n_pad, stream);
}

extern "C" int dp_gram_assembly_f64(const void* g, const void* lo, void* m,
                                    int nb, int h, int n_pad, void* stream) {
  return launch<double>(g, lo, m, nb, h, n_pad, stream);
}
