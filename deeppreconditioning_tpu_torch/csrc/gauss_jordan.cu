// Batched unpivoted Gauss–Jordan solve y = S^-1 e for N small systems.
//
// Replaces the TPU kernel deeppreconditioning_tpu/ops/fsai.py::_gj_kernel
// (launched by gauss_jordan_lanes / _masked_gauss_jordan_pallas).  Each
// system is an FSAI local block S (w x w, SPD with a unit diagonal after
// Jacobi scaling, identity on dead slots) and e is the one-hot of the
// diagonal slot.  Semantics follow _masked_gauss_jordan_xla: no pivoting
// and no guard on a zero pivot, float32 arithmetic throughout; at step k
// every other row i subtracts aug[i][k] / pivot_k times row k.  As in the
// TPU kernel, the division is one reciprocal of the pivot per step and
// multiplies; the reciprocal is the hardware's (__fdividef, within 2 ulp,
// and without the branch to IEEE division's slow path, which splits each
// step into blocks the scheduler cannot overlap).  Rounding differs from
// the plain version's division by an ulp or so per step.
//
// Layout: sub (N, w, w) row-major, e (N, w), y (N, w), all float32,
// contiguous and 16-byte aligned, 1 <= w <= 63.  The TPU kernel's
// lane-major (w, w+1, N) layout is not kept.
//
// What bounds it on an H100 (3350 GB/s HBM, 67 TFLOP/s float32): a system
// reads 4 (w^2 + w) bytes, writes 4 w and needs (w - 1) w (w + 1) flops
// (step k updates columns k+1..w of the w - 1 other rows).  Every width is
// bound by bytes: at N = 131072, w = 24 moves 327 MB (98 us), w = 41
// 924 MB (276 us; its flops 135 us) and w = 63 2.15 GB (641 us; its 32.8
// GFLOP 489 us); the scaling path's launch (w 13, N = 262144) moves
// 204 MB, 61 us.  A per-case setup (N = 768 or 1024) is a few microseconds
// of work, bound by the launch.  The previous design (one warp per system,
// a shuffle per row and step feeding one multiply-add per lane) was bound
// by shuffle issue at 0.16-0.25 of these bounds.
//
// Design: a system is held by a team of T threads of one warp, 32 / T
// systems per warp.  Each thread keeps R = W / T rows (rows j, j + T, ...)
// times all W + 1 columns of [S | e] in registers, so its multipliers
// aug[i][k] are its own.  At step k every thread takes 1 / pivot and row
// k's columns k+1..W from row k's owner by __shfl_sync, one shuffle per
// column for all the warp's teams at once, and each shuffled value feeds R
// multiply-adds.  (A pivot row written to shared memory and read back as
// 16-byte broadcasts, tried first, moved more through the SM's shared-
// memory pipe than the shuffles do: the owner's stores, and reads that a
// warp serves a quarter at a time.)  Against the old design (T = 32, R = 1
// per column) the shuffles per system fall by 32 / T and the multiply-adds
// per shuffle grow to R: (W, T, R) = (16, 4, 4), (24, 6, 4) (5 teams per
// warp, 2 lanes idle), (32, 8, 4), (42, 14, 3) (2 teams, 4 lanes idle),
// (48, 16, 3), (64, 32, 2), as far as the registers (R (W + 1) floats)
// allow.  Row k itself is left unscaled and scaled once at the end
// (y_k = aug[k][W] / pivot_k).  Columns 0..k are not updated at step k:
// they are unit columns and no later step reads them.  For W <= 8 one
// thread holds a whole system (T = 1) and nothing is communicated.
//
// The kernel is built for eight widths W (4, 8, 16, 24, 32, 42, 48, 64;
// 42 for the frame-structure width 41), and a call rounds w up to the next
// one inside the kernel: slots w..W-1 are identity rows with e = 0 and
// zero columns, never read from memory.  That is exact: at a padded pivot
// every real row's multiplier is exactly 0, and a real step never changes
// a padded row or column; padded steps are skipped.  Systems reach shared
// memory by cp.async 16-byte copies of the CTA's contiguous ranges of
// (N, w, w) and (N, w); rows of a width that is a multiple of 4 go to
// registers as float4.  A persistent grid (one wave of CTAs) walks the
// CTAs' ranges, and the copy of a CTA's next range runs while it
// eliminates the current one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

template <int W, int T>
struct Gj {
  static constexpr int R = W / T;             // rows per thread
  static constexpr int TPW = 32 / T;          // systems (teams) per warp
  static constexpr int TEAMS = kWarps * TPW;  // systems per CTA pass
};

// Shared memory of one CTA at runtime width w: the systems and right-hand
// sides of one pass.
template <int W, int T>
__host__ __device__ int smem_floats(int w) {
  return (Gj<W, T>::TEAMS * (w * w + w) + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `count` floats from src to dst (both 16-byte aligned) in 16-byte
// pieces over the CTA's threads; the last piece reads only what exists.
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             long long count) {
  for (long long v = threadIdx.x; v * 4 < count; v += kThreads) {
    const long long left = count - v * 4;
    cp_async16(dst + v * 4, src + v * 4,
               left >= 4 ? 16 : static_cast<int>(left) * 4);
  }
}

template <int W, int T>
__global__ void __launch_bounds__(kThreads)
gauss_jordan_kernel(const float* __restrict__ sub,
                    const float* __restrict__ e, float* __restrict__ y,
                    int n, int w) {
  using G = Gj<W, T>;
  constexpr int R = G::R;
  extern __shared__ __align__(16) float smem[];
  const int ww = w * w;
  float* s_sub = smem;
  float* s_e = smem + G::TEAMS * ww;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = lane / T < G::TPW;  // lanes past the last team idle
  const int team = warp * G::TPW + (active ? lane / T : 0);
  const int j = lane % T;
  const int base = lane / T * T;  // lane of the team's row slot 0
  const int chunks = (n + G::TEAMS - 1) / G::TEAMS;

  auto stage = [&](int chunk) {
    const long long s0 = static_cast<long long>(chunk) * G::TEAMS;
    const long long cnt = n - s0 < G::TEAMS ? n - s0 : G::TEAMS;
    stage_floats(s_sub, sub + s0 * ww, cnt * ww);
    stage_floats(s_e, e + s0 * w, cnt * w);
  };

  int chunk = blockIdx.x;
  if (chunk < chunks) stage(chunk);
  cp_async_commit();
  for (; chunk < chunks; chunk += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // the pass's systems are in shared memory

    // [S | e] rows j + T q of this team's system, identity past w; rows
    // of a width that is a multiple of 4 are read as float4.
    float a[R][W + 1];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = j + T * q;
      const float* srow = s_sub + team * ww + i * w;
      if (w % 4 == 0) {
#pragma unroll
        for (int g = 0; g < W / 4; ++g) {
          const bool live = i < w && 4 * g < w;  // w % 4 == 0: all four
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (live) v = reinterpret_cast<const float4*>(srow)[g];
          a[q][4 * g + 0] = live ? v.x : (i == 4 * g + 0 ? 1.0f : 0.0f);
          a[q][4 * g + 1] = live ? v.y : (i == 4 * g + 1 ? 1.0f : 0.0f);
          a[q][4 * g + 2] = live ? v.z : (i == 4 * g + 2 ? 1.0f : 0.0f);
          a[q][4 * g + 3] = live ? v.w : (i == 4 * g + 3 ? 1.0f : 0.0f);
        }
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          a[q][c] = (i < w && c < w) ? srow[c] : (i == c ? 1.0f : 0.0f);
        }
      }
      a[q][W] = i < w ? s_e[team * w + i] : 0.0f;
    }
    __syncthreads();  // every thread has read the stage
    if (chunk + static_cast<int>(gridDim.x) < chunks) {
      stage(chunk + gridDim.x);
    }
    cp_async_commit();

    float inv_row[R];
#pragma unroll
    for (int q = 0; q < R; ++q) inv_row[q] = 1.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k >= w) break;  // padded steps change no real row
      const int qk = k / T;  // static: the owner's row slot
      const int src = base + k % T;  // the owner's lane
      const bool owner = j == k % T;
      float inv = __fdividef(1.0f, a[qk][k]);  // no slow-path branch
      if constexpr (T > 1) inv = __shfl_sync(kFullMask, inv, src);
      float mult[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        // Row k (this thread's slot qk if it owns row k) stays unscaled.
        const bool pivot_row = q == qk && owner;
        mult[q] = pivot_row ? 0.0f : a[q][k] * inv;
        if (pivot_row) inv_row[q] = inv;
      }
#pragma unroll
      for (int c = k + 1; c <= W; ++c) {  // no branch: one block per step
        float u = a[qk][c];  // row k's column c, from its owner
        if constexpr (T > 1) u = __shfl_sync(kFullMask, u, src);
#pragma unroll
        for (int q = 0; q < R; ++q) a[q][c] = fmaf(-mult[q], u, a[q][c]);
      }
    }

    const long long sys = static_cast<long long>(chunk) * G::TEAMS + team;
    if (active && sys < n) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = j + T * q;
        if (i < w) y[sys * w + i] = a[q][W] * inv_row[q];
      }
    }
  }
}

template <int W, int T>
cudaError_t launch(const float* sub, const float* e, float* y, int n, int w,
                   cudaStream_t stream) {
  static int sms = 0;
  static int per_sm[W + 1] = {};  // resident CTAs per SM, by w
  const size_t smem = sizeof(float) * smem_floats<W, T>(w);
  if (per_sm[w] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        gauss_jordan_kernel<W, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats<W, T>(W)));
    int dev = 0, blocks = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, gauss_jordan_kernel<W, T>, kThreads, smem);
    }
    if (err != cudaSuccess) return err;
    per_sm[w] = blocks > 0 ? blocks : 1;
  }
  const int chunks = (n + Gj<W, T>::TEAMS - 1) / Gj<W, T>::TEAMS;
  const int wave = sms * per_sm[w];
  const int grid = chunks < wave ? chunks : wave;
  gauss_jordan_kernel<W, T><<<grid, kThreads, smem, stream>>>(sub, e, y, n,
                                                              w);
  return cudaGetLastError();
}

}  // namespace

// Solve sub[i] @ y[i] = e[i] for i < n at width w (1 <= w <= 63) on
// `stream`; w runs on the smallest built width W >= w.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dp_gauss_jordan_f32(const void* sub, const void* e, void* y,
                                   int n, int w, void* stream) {
  const float* s = static_cast<const float*>(sub);
  const float* rhs = static_cast<const float*>(e);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || w < 1 || w > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (w <= 4) {
    err = launch<4, 1>(s, rhs, out, n, w, st);
  } else if (w <= 8) {
    err = launch<8, 1>(s, rhs, out, n, w, st);
  } else if (w <= 16) {
    err = launch<16, 4>(s, rhs, out, n, w, st);
  } else if (w <= 24) {
    err = launch<24, 6>(s, rhs, out, n, w, st);
  } else if (w <= 32) {
    err = launch<32, 8>(s, rhs, out, n, w, st);
  } else if (w <= 42) {
    err = launch<42, 14>(s, rhs, out, n, w, st);
  } else if (w <= 48) {
    err = launch<48, 16>(s, rhs, out, n, w, st);
  } else {
    err = launch<64, 32>(s, rhs, out, n, w, st);
  }
  return static_cast<int>(err);
}
