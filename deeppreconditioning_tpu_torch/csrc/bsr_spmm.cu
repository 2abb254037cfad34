// Block-sparse (BSR) matrix product Y = A X, X of shape (n_pad, m).
//
// Replaces the TPU kernel deeppreconditioning_tpu/ops/pallas_bsr.py::
// bsr_matmat_pallas (its inner `kernel`, also reached through
// bsr_matvec_pallas).  Semantics follow BSRMatrix.matmat: for every block
// row i and slot s, Y[i-block] += blocks[i, s] (bs x bs) @ X[block_cols[i,
// s]-block] (bs x m), summed in float32; a block-column id outside
// [0, R) (the sentinel R marks an empty slot) reads a zero X block.  The
// reference's zero-padded copy of X is a bounds check here.  Every stored
// slot's block is read, the sentinel's included, as the TPU kernel DMAs
// it, so a call moves R * S * bs^2 * 4 bytes of blocks plus X and Y.
//
// Layout: blocks (R, S, bs, bs) row-major, block_cols (R, S) int32,
// X (R * bs, m) and Y (R * bs, m) row-major, float32, contiguous;
// bs in {16, 32, 64, 128}, m >= 1.  For m == 1, X and the blocks must be
// 16-byte aligned (float4 loads).
//
// What bounds it on an H100: at m = 1 every block entry is used once for
// one multiply-add (0.5 flop per byte), so HBM bandwidth is the limit.
// The operators it serves hold 0.27-1 GB of blocks (frame structure
// 30x30x20 at bs 128: 802 x 9 blocks, 473 MB), far past the 50 MB L2, so
// every call streams them from HBM.  At m = 128 the blocks are reused
// across the columns and the multiply-adds (2 bs flops per block entry
// and column) dominate.
//
// Design, m == 1: one CTA per block row.  A block row of bs floats is
// read as bs / 4 float4 by consecutive threads (a warp covers one row at
// bs 128, 128 / bs rows below), so the block streams coalesced in 16-byte
// loads; each thread keeps the float4 of the slot's x block that its row
// segment meets and accumulates its partial dot products over the slots
// in registers; a warp-shuffle reduction over the row's bs / 4 threads
// gives y.  CTAs have min(256, bs^2 / 4) threads, so each thread reads
// bs^2 / 4 / threads float4 per slot (16 at bs 128), all in flight at once.
// Design, m > 1: one CTA (8 warps) per (block row, tile of 32 columns);
// per slot the X block's bs x 32 tile is staged in shared memory (zero
// for the sentinel), each warp owns bs / 8 rows, reads each row of the
// block coalesced 32 entries at a time and broadcasts them by shuffle, and
// lane j accumulates column j.  The block is read once per column tile.
// wgmma, TMA and tensor cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTileCols = 32;  // m > 1: columns per CTA, one per lane
constexpr int kWarps = 8;      // m > 1: warps per CTA

template <int BS>
__host__ __device__ constexpr int spmv_threads() {
  return BS * BS / 4 < 256 ? BS * BS / 4 : 256;
}

template <int BS>
__global__ void __launch_bounds__(spmv_threads<BS>())
bsr_spmv_kernel(const float* __restrict__ blocks,
                const int* __restrict__ cols, const float* __restrict__ x,
                float* __restrict__ y, int r, int s) {
  constexpr int kThreads = spmv_threads<BS>();
  constexpr int kLanesPerRow = BS / 4;                   // float4 per row
  constexpr int kRowsPerPass = kThreads / kLanesPerRow;  // rows per sweep
  constexpr int kPasses = BS / kRowsPerPass;
  const int seg = threadIdx.x % kLanesPerRow;
  const int rsub = threadIdx.x / kLanesPerRow;
  const long long i = blockIdx.x;

  float acc[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) acc[p] = 0.0f;

  for (int sl = 0; sl < s; ++sl) {
    const long long slot = i * s + sl;
    const int c = __ldg(cols + slot);
    float4 xv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c >= 0 && c < r) {
      xv = __ldg(reinterpret_cast<const float4*>(
                     x + static_cast<long long>(c) * BS) + seg);
    }
    const float4* blk =
        reinterpret_cast<const float4*>(blocks + slot * BS * BS);
    float4 b[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      b[p] = __ldg(blk + (p * kRowsPerPass + rsub) * kLanesPerRow + seg);
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      acc[p] += b[p].x * xv.x + b[p].y * xv.y + b[p].z * xv.z +
                b[p].w * xv.w;
    }
  }

#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFullMask, v, off);  // within the row's lanes
    }
    if (seg == 0) y[i * BS + p * kRowsPerPass + rsub] = v;
  }
}

template <int BS>
__global__ void __launch_bounds__(32 * kWarps)
bsr_spmm_kernel(const float* __restrict__ blocks,
                const int* __restrict__ cols, const float* __restrict__ x,
                float* __restrict__ y, int r, int s, int m, int tiles) {
  constexpr int kRowsPerWarp = BS / kWarps;
  constexpr int kChunk = BS < 32 ? BS : 32;  // block entries per shuffle round
  __shared__ float xs[BS][kTileCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = blockIdx.x / tiles;
  const int col = (blockIdx.x % tiles) * kTileCols + lane;
  const bool live = col < m;

  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;

  for (int sl = 0; sl < s; ++sl) {
    const long long slot = i * s + sl;
    const int c = __ldg(cols + slot);
    __syncthreads();  // the previous slot's tile has been read
    for (int k = warp; k < BS; k += kWarps) {
      xs[k][lane] = (live && c >= 0 && c < r)
          ? __ldg(x + (static_cast<long long>(c) * BS + k) * m + col)
          : 0.0f;
    }
    __syncthreads();
    const float* blk = blocks + slot * BS * BS;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const float* row = blk + (warp * kRowsPerWarp + q) * BS;
#pragma unroll
      for (int k0 = 0; k0 < BS; k0 += kChunk) {
        const float a = lane < kChunk ? __ldg(row + k0 + lane) : 0.0f;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          acc[q] += __shfl_sync(kFullMask, a, j) * xs[k0 + j][lane];
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      y[(i * BS + warp * kRowsPerWarp + q) * m + col] = acc[q];
    }
  }
}

template <int BS>
cudaError_t launch(const float* blocks, const int* cols, const float* x,
                   float* y, int r, int s, int m, cudaStream_t stream) {
  if (m == 1) {
    bsr_spmv_kernel<BS><<<r, spmv_threads<BS>(), 0, stream>>>(
        blocks, cols, x, y, r, s);
  } else {
    const int tiles = (m + kTileCols - 1) / kTileCols;
    const long long grid = static_cast<long long>(r) * tiles;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    bsr_spmm_kernel<BS><<<static_cast<int>(grid), 32 * kWarps, 0, stream>>>(
        blocks, cols, x, y, r, s, m, tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// Y = A X for the BSR matrix (blocks, block_cols) with R = r block rows,
// S = s slots and block size bs, X of m columns, on `stream`.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int dp_bsr_spmm_f32(const void* blocks, const void* block_cols,
                               const void* x, void* y, int r, int s, int bs,
                               int m, void* stream) {
  if (r < 1 || s < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(blocks);
  const int* c = static_cast<const int*>(block_cols);
  const float* xin = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: return static_cast<int>(launch<16>(b, c, xin, out, r, s, m, st));
    case 32: return static_cast<int>(launch<32>(b, c, xin, out, r, s, m, st));
    case 64: return static_cast<int>(launch<64>(b, c, xin, out, r, s, m, st));
    case 128:
      return static_cast<int>(launch<128>(b, c, xin, out, r, s, m, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
