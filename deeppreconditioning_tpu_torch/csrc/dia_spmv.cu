// Banded (DIA) sparse matrix-vector product y = A x: kernel B2.
//
// Replaces the TPU kernel deeppreconditioning_tpu/ops/pallas_spmv.py::
// _dia_kernel (launched by dia_matvec_pallas).  Semantics follow
// DIAMatrix.matvec: y[i] = sum_d vals[d][i] * x[i + off_d] for every row
// i < n_pad, with x read as zero outside [0, n_pad), summed in band order
// from 0.  Each product and each sum rounds on its own (__fmul_rn and
// __fadd_rn, which the compiler does not contract into a fused
// multiply-add), exactly as the plain version's separate multiply and
// add passes do, so the two agree bit for bit.  A fused multiply-add
// differed by ~1e-5 absolute on the multigrid coarse operators, whose
// rows cancel terms of ~1e2 down to results near 0.  Staging x in shared
// memory copies it exactly: it changes no product.
//
// Layout: vals (batch, n_diag, n_pad) row-major, x (batch, n_pad), y
// (batch, n_pad), float32, contiguous, 16-byte aligned, n_pad a multiple
// of 4 (every operator of the port pads n_pad to a multiple of 1024);
// batch 1 is the plain (n_diag, n_pad) operator.  A batch is S operators
// of one band layout, one per sample (the structured trainer's), all in
// one launch: blockIdx.y is the sample.
//
// What bounds it on an H100 (utils/profiling.dia_work): per row it reads
// n_diag values and x and writes y, (n_diag + 2) * 4 bytes against
// 3350 GB/s of HBM, and does 2 * n_diag flops: about 0.5 flop per byte,
// far below the card's ~20 flop/byte float32 balance, so HBM bandwidth is
// the limit.  One 128^3 7-band call moves 75.5 MB, more than the 50 MB
// L2, so back-to-back calls stream from HBM.  A call of the structured
// trainer's batch (32 x 7 x 2048, 2.4 MB) is instead held by the launch
// and one DRAM round trip.
//
// Design.  The host builds a launch plan once per operator
// (ops/dia_spmv.py::tile_geometry) and passes it by pointer; the kernel
// reads it as a __grid_constant__ parameter, so nothing is copied to the
// device per call.
// - Tile: a CTA owns T = threads * R consecutive rows of one sample.  A
//   thread owns R consecutive rows (R = 4 up to 8 bands, 2 up to 16, 1
//   above, so that no instance spills) and reads each band's R values as
//   one 16-, 8- or 4-byte load: the bands start at d * n_pad, so these
//   loads are aligned and a warp's are coalesced.  The plan picks the
//   threads, hence T: the windows fit 48 KB of shared memory (no opt-in
//   attribute) and the grid gives every one of the 132 SMs a CTA (the
//   trainer's batch has 65 536 rows, so T = 1024 would leave half the
//   card idle).  Smaller R are built too, for the tile sweep
//   (scripts/torch_dia_tile_sweep.py) that measures them.
// - Windows: the sorted offsets are merged into groups wherever two
//   neighbours lie less than T apart.  Group g's window of x, [t0 +
//   min_g, t0 + T + max_g) rounded out to 16-byte chunks, is staged in
//   shared memory once per tile with 16-byte cp.async (.cg: through L2
//   only); the chunks outside [0, n_pad) are zero-filled (src-size 0).
//   Since n_pad is a multiple of 4, a chunk lies wholly inside or wholly
//   outside.  Every band of the group then reads x from shared memory, so
//   x leaves L2 once per tile and group instead of once per band.  A
//   128^3 7-point operator has three windows (T, T + 256, T), not the TPU
//   kernel's one window around all offsets (T + 2 * 16384).  TMA's 1-D
//   bulk copy cannot zero-fill the part of a window outside x, and a
//   tensor map that could is encoded per x pointer on the host
//   (cuTensorMapEncodeTiled before every launch); the windows' starts
//   also fall off the 16-byte grid at odd offsets until rounded out.  So
//   cp.async, chunk by chunk.
// - The band loads, which go to HBM, are issued first, then the window
//   copies, then the wait: the two overlap.
// - Shared-memory reads: band d's x for a thread's rows starts at
//   band_base[d] + r0, at any alignment.  The thread loads the two aligned
//   R-vectors around it and selects by the shift (band_base[d] mod R, the
//   same in every thread), so no read is bank-conflicted; the plan pads
//   the windows by one chunk for the second vector.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 32;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;  // no opt-in attribute below this
constexpr int kChunk = 4;                 // floats in a 16-byte cp.async
constexpr int kMaxBatch = 65535;          // the sample is gridDim.y

// The launch plan, field for field ops/dia_spmv.py::_PlanParams.
struct DiaPlan {
  int n_diag;
  int n_pad;
  int batch;
  int threads;
  int rows;         // R: rows per thread
  int tiles;        // CTAs per sample
  int smem_floats;  // shared memory of a CTA, in floats
  int n_groups;
  int win_start[kMaxDiags];   // window start - tile start, multiple of 4
  int win_chunks[kMaxDiags];  // 16-byte chunks in the window
  int win_base[kMaxDiags];    // first float of the window in shared memory
  int band_base[kMaxDiags];   // shared index of x[t0 + off_d], band order
};

// The rows a thread owns: its band values stay at 32 registers or fewer.
// A plan may pin fewer (1, 2 or 4), as the tile sweep does.
__host__ __device__ constexpr int max_rows_for(int n_diag) {
  return n_diag <= 8 ? 4 : (n_diag <= 16 ? 2 : 1);
}

template <int R> struct VecOf;
template <> struct VecOf<4> { using type = float4; };
template <> struct VecOf<2> { using type = float2; };
template <> struct VecOf<1> { using type = float; };

__device__ __forceinline__ void unpack(const float4& v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack(const float2& v, float* o) {
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void unpack(const float& v, float* o) {
  o[0] = v;
}

__device__ __forceinline__ void store_rows(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_rows(float* p, const float (&a)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store_rows(float* p, const float (&a)[1]) {
  *p = a[0];
}

// R consecutive band values from global memory, one aligned vector load.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&o)[R]) {
  using V = typename VecOf<R>::type;
  unpack(__ldg(reinterpret_cast<const V*>(p)), o);
}

// s[at .. at + R) from shared memory: the two aligned R-vectors around it,
// then a select by the shift (uniform across the CTA).
template <int R>
__device__ __forceinline__ void shared_rows(const float* s, int at,
                                            float (&o)[R]) {
  if constexpr (R == 1) {
    o[0] = s[at];
  } else {
    using V = typename VecOf<R>::type;
    const int shift = at & (R - 1);
    const V* v = reinterpret_cast<const V*>(s + (at - shift));
    float w[2 * R];
    unpack(v[0], w);
    unpack(v[1], w + R);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float pick = w[k];
#pragma unroll
      for (int t = 1; t < R; ++t) pick = shift == t ? w[k + t] : pick;
      o[k] = pick;
    }
  }
}

__device__ __forceinline__ void cp_async_16(float* smem_dst,
                                            const float* gmem_src,
                                            int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem_src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int ND, int R>
__global__ void __launch_bounds__(kMaxThreads)
dia_spmv_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, const __grid_constant__ DiaPlan p) {
  extern __shared__ float4 window_mem[];
  float* win = reinterpret_cast<float*>(window_mem);
  const int n_pad = p.n_pad;
  const long long sample = blockIdx.y;
  const float* xs = x + sample * n_pad;
  const int t0 = blockIdx.x * (blockDim.x * R);

  // 1. the thread's R rows of every band: the loads that go to HBM, first
  const int r0 = threadIdx.x * R;
  const int i0 = t0 + r0;
  const bool live = i0 < n_pad;  // all R rows or none: R divides n_pad
  float a[ND][R];
  if (live) {
    const float* v = vals + sample * ND * static_cast<long long>(n_pad) + i0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      load_rows<R>(v + static_cast<long long>(d) * n_pad, a[d]);
    }
  }

  // 2. this tile's x windows, zero outside [0, n_pad), in flight with them
  for (int g = 0; g < p.n_groups; ++g) {
    const int start = t0 + p.win_start[g];
    const int chunks = p.win_chunks[g];
    float* dst = win + p.win_base[g];
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int j = start + kChunk * c;
      const bool inside = j >= 0 && j < n_pad;
      cp_async_16(dst + kChunk * c, xs + (inside ? j : 0), inside ? 16 : 0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;

  // 3. y = sum_d a[d] * x[i + off_d], in band order, rounded per step
  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    float xv[R];
    shared_rows<R>(win, p.band_base[d] + r0, xv);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      acc[k] = __fadd_rn(acc[k], __fmul_rn(a[d][k], xv[k]));
    }
  }
  store_rows(y + sample * n_pad + i0, acc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Everything the kernel relies on for in-bounds accesses.
bool plan_ok(const DiaPlan& p, const void* vals, const void* x,
             const void* y) {
  if (p.n_diag < 1 || p.n_diag > kMaxDiags || p.n_pad < kChunk ||
      p.n_pad % kChunk != 0 || p.batch < 1 || p.batch > kMaxBatch ||
      p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 != 0 ||
      (p.rows != 1 && p.rows != 2 && p.rows != 4) ||
      p.rows > max_rows_for(p.n_diag) || p.n_groups < 1 ||
      p.n_groups > p.n_diag || p.smem_floats < kChunk ||
      p.smem_floats % kChunk != 0 ||
      p.smem_floats > kMaxSmemBytes / static_cast<int>(sizeof(float))) {
    return false;
  }
  const long long tile = static_cast<long long>(p.threads) * p.rows;
  if (p.tiles < 1 || p.tiles * tile < p.n_pad ||
      (p.tiles - 1) * tile >= p.n_pad) {
    return false;
  }
  for (int g = 0; g < p.n_groups; ++g) {
    if (p.win_start[g] % kChunk != 0 || p.win_base[g] % kChunk != 0 ||
        p.win_base[g] < 0 || p.win_chunks[g] < 0 ||
        p.win_base[g] + static_cast<long long>(kChunk) * p.win_chunks[g] >
            p.smem_floats) {
      return false;
    }
  }
  for (int d = 0; d < p.n_diag; ++d) {
    // a thread's reads end before band_base + tile + R
    if (p.band_base[d] < 0 || p.band_base[d] + tile + p.rows > p.smem_floats) {
      return false;
    }
  }
  return aligned16(vals) && aligned16(x) && aligned16(y);
}

template <int ND, int R>
cudaError_t launch_rows(const float* vals, const float* x, float* y,
                        const DiaPlan& p, cudaStream_t stream) {
  const dim3 grid(p.tiles, p.batch);
  dia_spmv_kernel<ND, R><<<grid, p.threads, p.smem_floats * sizeof(float),
                           stream>>>(vals, x, y, p);
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch(const float* vals, const float* x, float* y,
                   const DiaPlan& p, cudaStream_t stream) {
  if constexpr (max_rows_for(ND) >= 4) {
    if (p.rows == 4) return launch_rows<ND, 4>(vals, x, y, p, stream);
  }
  if constexpr (max_rows_for(ND) >= 2) {
    if (p.rows == 2) return launch_rows<ND, 2>(vals, x, y, p, stream);
  }
  return launch_rows<ND, 1>(vals, x, y, p, stream);
}

}  // namespace

// y[s] = A[s] x[s] for the `batch` DIA matrices of the launch plan `plan`
// (a DiaPlan built by ops/dia_spmv.py) on `stream`.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan or pointers it does not take.
extern "C" int dp_dia_spmv_f32(const void* vals, const void* x, void* y,
                               const void* plan, void* stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DiaPlan& p = *static_cast<const DiaPlan*>(plan);
  if (!plan_ok(p, vals, x, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* v = static_cast<const float*>(vals);
  const float* xin = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.n_diag) {
#define DP_DIA_CASE(ND) \
  case ND:              \
    return static_cast<int>(launch<ND>(v, xin, out, p, st));
    DP_DIA_CASE(1) DP_DIA_CASE(2) DP_DIA_CASE(3) DP_DIA_CASE(4)
    DP_DIA_CASE(5) DP_DIA_CASE(6) DP_DIA_CASE(7) DP_DIA_CASE(8)
    DP_DIA_CASE(9) DP_DIA_CASE(10) DP_DIA_CASE(11) DP_DIA_CASE(12)
    DP_DIA_CASE(13) DP_DIA_CASE(14) DP_DIA_CASE(15) DP_DIA_CASE(16)
    DP_DIA_CASE(17) DP_DIA_CASE(18) DP_DIA_CASE(19) DP_DIA_CASE(20)
    DP_DIA_CASE(21) DP_DIA_CASE(22) DP_DIA_CASE(23) DP_DIA_CASE(24)
    DP_DIA_CASE(25) DP_DIA_CASE(26) DP_DIA_CASE(27) DP_DIA_CASE(28)
    DP_DIA_CASE(29) DP_DIA_CASE(30) DP_DIA_CASE(31) DP_DIA_CASE(32)
#undef DP_DIA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
