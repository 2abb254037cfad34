// Batched unpivoted Gauss–Jordan solve y = S^-1 e for N small systems.
//
// Replaces the TPU kernel deeppreconditioning_tpu/ops/fsai.py::_gj_kernel
// (launched by gauss_jordan_lanes / _masked_gauss_jordan_pallas).  Each
// system is an FSAI local block S (w x w, SPD with a unit diagonal after
// Jacobi scaling, identity on dead slots) and e is the one-hot of the
// diagonal slot.  Semantics follow _masked_gauss_jordan_xla exactly: no
// pivoting and no guard on a zero pivot; at step k the pivot row is
// divided by the pivot, every other row i subtracts aug[i][k] * row_k, and
// row k is replaced by row_k; float32 arithmetic throughout.
//
// Layout: sub (N, w, w) row-major, e (N, w), y (N, w), all float32 and
// contiguous, 1 <= w <= 63.  The TPU kernel's lane-major (w, w+1, N)
// layout is not kept.
//
// What bounds it on an H100: at w = 24 a system reads 2.4 KB and does
// about 29 kFLOP (24 steps x 25 columns x 24 rows x 2); at w = 41 (the
// frame-structure checkpoint) 6.9 KB and about 145 kFLOP.  A per-case
// setup solves N = n_pad systems (1024 or 768), i.e. that many warps in
// flight, well under the ~8.4k warps that 132 SMs hold, so a launch is
// bound by latency (the step-to-step dependency chain of shuffles and one
// division) and by launch overhead, not by HBM bandwidth or FLOPs.
//
// Design: one warp per system.  The w + 1 columns of [S | e] are dealt to
// the lanes in NC = ceil((w + 1) / 32) sets: lane q keeps columns q,
// q + 32, ... in registers (col[c][i] is entry i of column q + 32 c), so
// w <= 31 takes one set and 32 <= w <= 63 two.  The kernel is templated
// on W so every register array index is static (fully unrolled, no
// local-memory spill).  At step k lane k % 32 holds column k; its entries
// are broadcast with __shfl_sync, each lane scales its own pivot-row
// entries and updates its columns; afterwards column W (the lane W % 32,
// set W / 32) is y.  Loads are coalesced (for each row i, lanes read
// consecutive entries).  Four warps per block spread a 1024-system launch
// over 256 blocks, i.e. over every SM.  Several systems per warp,
// shared-memory staging or wgmma are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gauss_jordan_kernel(const float* __restrict__ sub,
                    const float* __restrict__ e,
                    float* __restrict__ y, int n) {
  constexpr int NC = (W + 32) / 32;  // column sets for the W + 1 columns
  const int lane = threadIdx.x & 31;
  const long long sys =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (sys >= n) return;  // the whole warp leaves: shuffles stay full-mask

  const float* s = sub + sys * W * W;
  float col[NC][W];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = lane + 32 * c;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      col[c][i] = q < W ? s[i * W + q] : (q == W ? e[sys * W + i] : 0.0f);
    }
  }

#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int kc = k / 32, kl = k % 32;  // static after unrolling
    const float pivot = __shfl_sync(kFullMask, col[kc][k], kl);
    float row_k[NC];  // this lane's pivot-row entries
#pragma unroll
    for (int c = 0; c < NC; ++c) row_k[c] = col[c][k] / pivot;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i == k) continue;
      const float a_ik = __shfl_sync(kFullMask, col[kc][i], kl);  // aug[i][k]
#pragma unroll
      for (int c = 0; c < NC; ++c) col[c][i] = col[c][i] - a_ik * row_k[c];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) col[c][k] = row_k[c];
  }

  constexpr int ec = W / 32, el = W % 32;  // where column W (y) lives
  float out[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float v = __shfl_sync(kFullMask, col[ec][i], el);
    if (lane == i % 32) out[i / 32] = v;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = lane + 32 * c;
    if (q < W) y[sys * W + q] = out[c];
  }
}

template <int W>
cudaError_t launch(const float* sub, const float* e, float* y, int n,
                   cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gauss_jordan_kernel<W><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      sub, e, y, n);
  return cudaGetLastError();
}

}  // namespace

// Solve sub[i] @ y[i] = e[i] for i < n at width w (1 <= w <= 63) on
// `stream`.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dp_gauss_jordan_f32(const void* sub, const void* e, void* y,
                                   int n, int w, void* stream) {
  const float* s = static_cast<const float*>(sub);
  const float* rhs = static_cast<const float*>(e);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
#define DP_GJ_CASE(W) \
  case W:             \
    return static_cast<int>(launch<W>(s, rhs, out, n, st));
    DP_GJ_CASE(1) DP_GJ_CASE(2) DP_GJ_CASE(3) DP_GJ_CASE(4)
    DP_GJ_CASE(5) DP_GJ_CASE(6) DP_GJ_CASE(7) DP_GJ_CASE(8)
    DP_GJ_CASE(9) DP_GJ_CASE(10) DP_GJ_CASE(11) DP_GJ_CASE(12)
    DP_GJ_CASE(13) DP_GJ_CASE(14) DP_GJ_CASE(15) DP_GJ_CASE(16)
    DP_GJ_CASE(17) DP_GJ_CASE(18) DP_GJ_CASE(19) DP_GJ_CASE(20)
    DP_GJ_CASE(21) DP_GJ_CASE(22) DP_GJ_CASE(23) DP_GJ_CASE(24)
    DP_GJ_CASE(25) DP_GJ_CASE(26) DP_GJ_CASE(27) DP_GJ_CASE(28)
    DP_GJ_CASE(29) DP_GJ_CASE(30) DP_GJ_CASE(31) DP_GJ_CASE(32)
    DP_GJ_CASE(33) DP_GJ_CASE(34) DP_GJ_CASE(35) DP_GJ_CASE(36)
    DP_GJ_CASE(37) DP_GJ_CASE(38) DP_GJ_CASE(39) DP_GJ_CASE(40)
    DP_GJ_CASE(41) DP_GJ_CASE(42) DP_GJ_CASE(43) DP_GJ_CASE(44)
    DP_GJ_CASE(45) DP_GJ_CASE(46) DP_GJ_CASE(47) DP_GJ_CASE(48)
    DP_GJ_CASE(49) DP_GJ_CASE(50) DP_GJ_CASE(51) DP_GJ_CASE(52)
    DP_GJ_CASE(53) DP_GJ_CASE(54) DP_GJ_CASE(55) DP_GJ_CASE(56)
    DP_GJ_CASE(57) DP_GJ_CASE(58) DP_GJ_CASE(59) DP_GJ_CASE(60)
    DP_GJ_CASE(61) DP_GJ_CASE(62) DP_GJ_CASE(63)
#undef DP_GJ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
