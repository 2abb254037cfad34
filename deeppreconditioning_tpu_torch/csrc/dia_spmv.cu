// Banded (DIA) sparse matrix-vector product y = A x.
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
// rows cancel terms of ~1e2 down to results near 0.
//
// Layout: vals (batch, n_diag, n_pad) row-major, x (batch, n_pad), y
// (batch, n_pad), float32, contiguous; batch 1 is the plain (n_diag, n_pad)
// operator.  A batch is S operators of one band layout, one per sample
// (the structured trainer's), all in one launch: blockIdx.y is the sample.
// The offsets (at most 32) reach the kernel by value in a parameter
// struct: no device copy per call.
//
// What bounds it on an H100: per row it reads n_diag values and n_diag
// entries of x and writes one y, 2 * n_diag flops for about
// (n_diag + 2) * 4 bytes of HBM traffic once x's shifted reads hit in
// L1/L2: about 0.5 flop per byte, far below the card's ~20 flop/byte
// fp32 balance, so HBM bandwidth is the limit.  One 128^3 7-band call
// moves (7 + 2) * 2^21 * 4 = 75.5 MB, more than the 50 MB L2, so
// back-to-back calls stream from HBM.
//
// Design: one thread per row in a grid-stride loop, so a warp reads 32
// consecutive entries of each band and of each shifted x window
// (coalesced).  The kernel is templated on the band count so the band
// loop unrolls fully and all 2 * n_diag loads of a row issue before the
// first product.  The TPU kernel's VMEM tiles, halo DMA and
// double buffering are not kept: L2 and L1 serve the reuse of x across
// the bands (x is read n_diag times from cache, once from HBM).
// Shared-memory x tiles with a halo, float4 loads and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 32;
constexpr int kThreads = 256;

struct Offsets {
  int v[kMaxDiags];
};

template <int ND>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, const Offsets offs, int n_pad) {
  const long long sample = blockIdx.y;
  vals += sample * ND * static_cast<long long>(n_pad);
  x += sample * n_pad;
  y += sample * n_pad;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_pad;
       i += stride) {
    float a[ND], xv[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int j = i + offs.v[d];
      a[d] = __ldg(vals + static_cast<long long>(d) * n_pad + i);
      xv[d] = (j >= 0 && j < n_pad) ? __ldg(x + j) : 0.0f;
    }
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc = __fadd_rn(acc, __fmul_rn(a[d], xv[d]));
    }
    y[i] = acc;
  }
}

template <int ND>
cudaError_t launch(const float* vals, const float* x, float* y,
                   const Offsets& offs, int n_pad, int batch,
                   cudaStream_t stream) {
  const long long blocks_needed =
      (static_cast<long long>(n_pad) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      blocks_needed < (1 << 20) ? blocks_needed : (1 << 20));
  const dim3 grid(blocks, batch);
  dia_spmv_kernel<ND><<<grid, kThreads, 0, stream>>>(vals, x, y, offs,
                                                     n_pad);
  return cudaGetLastError();
}

}  // namespace

// y[s] = A[s] x[s] for the `batch` DIA matrices (vals,
// offsets_host[0..n_diag)) on `stream`, 1 <= n_diag <= 32, n_pad >= 1,
// 1 <= batch <= 65535.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int dp_dia_spmv_f32(const void* vals, const void* x, void* y,
                               const int* offsets_host, int n_diag,
                               int n_pad, int batch, void* stream) {
  if (n_diag < 1 || n_diag > kMaxDiags || n_pad < 1 || batch < 1 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets offs = {};
  for (int d = 0; d < n_diag; ++d) offs.v[d] = offsets_host[d];
  const float* v = static_cast<const float*>(vals);
  const float* xin = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_diag) {
#define DP_DIA_CASE(ND) \
  case ND:              \
    return static_cast<int>(launch<ND>(v, xin, out, offs, n_pad, batch, st));
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
