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
// it, so a call moves R * S * bs^2 * 4 bytes of blocks plus X and Y; the
// product needs only the non-sentinel blocks (7002 of the frame operator's
// 7218 slots, 5154 of 6576 and 12212 of 15536 on the 48^3 and 64^3
// stencils), and its bound counts only those.
//
// Layout: blocks (R, S, bs, bs) row-major, block_cols (R, S) int32,
// X (R * bs, m) and Y (R * bs, m) row-major, float32, contiguous;
// bs in {16, 32, 64, 128}, m >= 1.  The blocks must be 16-byte aligned
// (16-byte loads and copies), and X too for m == 1.
//
// What bounds it on an H100 (3350 GB/s HBM; 67 TFLOP/s float32 outside
// the tensor cores, 495 TFLOP/s TF32 inside them).  At m = 1 every block
// entry is used once for one multiply-add (0.5 flop per byte), so HBM
// bandwidth is the limit: the operators it serves hold 0.27-1 GB of blocks
// (frame structure 30x30x20 at bs 128: 802 x 9 slots, 473 MB stored,
// 459 MB in its 7002 non-sentinel blocks), far past the 50 MB L2.  On the
// frame operator m = 8 needs 465 MB and 1.8 GFLOP: bound by bytes,
// 139 us.  m = 128 needs 564 MB (168 us) and 29.4 GFLOP, 438 us at the
// float32 roof: only the tensor cores can go below it, and 3xTF32 (three
// TF32 products per float32 product) puts their roof at 165 TFLOP/s,
// 178 us, the bound it is held to.
//
// Design, m == 1: one CTA per block row.  A block row of bs floats is
// read as bs / 4 float4 by consecutive threads (a warp covers one row at
// bs 128, 128 / bs rows below), so the block streams coalesced in 16-byte
// loads; each thread keeps the float4 of the slot's x block that its row
// segment meets and accumulates its partial dot products over the slots
// in registers; a warp-shuffle reduction over the row's bs / 4 threads
// gives y.  CTAs have min(256, bs^2 / 4) threads, so each thread reads
// bs^2 / 4 / threads float4 per slot (16 at bs 128), all in flight at once.
//
// Design, m > 1: one CTA per (block row, tile of NT columns), NT = 8 for
// m <= 8 and 64 above (the tile index
// varies fastest, so the CTAs that share a block row run together and
// the block's second read comes from L2).  The products run on the tensor
// cores, mma.sync m16n8k8 in TF32 with the 3xTF32 split: a = a_hi + a_lo,
// b = b_hi + b_lo, D += a_lo b_hi + a_hi b_lo + a_hi b_hi in float32
// accumulators that stay in registers across all slots of the block row.
// Single-pass TF32 would keep ~3 decimal digits; the split keeps float32's
// (the plain version and the reference run float32 products).  Operands
// stream through a ring of 3-4 shared-memory stages, each one k-slice of
// the slot's block (bs x 32) and of its X tile (32 x NT), copied by
// cp.async 16-byte copies (4-byte ones when X's rows are not 16-byte
// aligned) so that the copies of the next slices overlap the products of
// this one; the sentinel's X slice is zero-filled by the copy.  At m = 8
// (NT = 8) each warp owns 16 rows, the work per byte is small, and the
// four stages keep ~64 KB per CTA, two CTAs per SM, in flight: the kernel
// streams the blocks.  At m = 128 (two CTAs of NT = 64 per block row, two
// per SM) each warp owns a 32 x 32 tile, so one split fragment of A feeds
// 4 MMAs and one of X feeds 2; mma.sync, not the bytes, bounds it there.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

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

// m > 1: the tiling of one CTA, which owns block row i and NT columns of
// Y.  Its warps form a WM x WN grid; each warp owns MF 16-row and NF
// 8-column MMA tiles.  The ring streams k-slices of KS block columns:
// a stage holds the slice of the block (BS x KS, row stride AS) and the
// slice of the X tile (KS x NT, row stride XS).  The strides make the
// fragment loads conflict-free: AS = 8 (mod 32) for the float2 loads of
// A, XS = 4 or 12 (mod 16) for the scalar loads of X.
template <int BS, int NT>
struct Spmm {
  static constexpr int KS = BS < 32 ? BS : 32;
  static constexpr int MF = (BS >= 64 && NT >= 64) ? 2 : 1;
  static constexpr int WM = BS / (16 * MF);
  static constexpr int WN = 8 / WM < NT / 8 ? 8 / WM : NT / 8;
  static constexpr int NF = NT / (8 * WN);
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int AS = KS + 8;
  static constexpr int XS = NT + 4;
  static constexpr int STAGE_FLOATS = BS * AS + KS * XS;
  // Four stages, or three where four would keep a second CTA off the SM.
  static constexpr int STAGES = 4 * STAGE_FLOATS * 4 <= 113 * 1024 ? 4 : 3;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo: hi keeps the 10 explicit mantissa bits of TF32 (the low 13
// bits masked off, one logic op instead of a conversion) and lo = v - hi
// is exact; the MMA reads lo's top 19 bits.  hi + lo then holds v to 2^-20
// of its size, and the dropped lo * lo term is smaller still.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BS, int NT>
__global__ void __launch_bounds__(Spmm<BS, NT>::THREADS,
                                  Spmm<BS, NT>::MIN_BLOCKS)
bsr_spmm_kernel(const float* __restrict__ blocks,
                const int* __restrict__ cols, const float* __restrict__ x,
                float* __restrict__ y, int r, int s, int m, int tiles,
                int vec4) {
  using C = Spmm<BS, NT>;
  constexpr int KSTEPS = BS / C::KS;  // k-slices per block
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int wm = warp / C::WN, wn = warp % C::WN;
  const long long i = blockIdx.x / tiles;
  const int col0 = (blockIdx.x % tiles) * NT;
  const int steps = s * KSTEPS;

  // Issue the copies of ring step `step` (slot step / KSTEPS, k-slice
  // step % KSTEPS) into its stage; the sentinel's X rows are zero-filled.
  auto load = [&](int step) {
    float* as = smem + (step % C::STAGES) * C::STAGE_FLOATS;
    float* xs = as + BS * C::AS;
    const long long slot = i * s + step / KSTEPS;
    const int kk = (step % KSTEPS) * C::KS;
    const int c = __ldg(cols + slot);
    const float* blk = blocks + slot * BS * BS + kk;
#pragma unroll
    for (int idx = tid; idx < BS * C::KS / 4; idx += C::THREADS) {
      const int rr = idx / (C::KS / 4), cc = (idx % (C::KS / 4)) * 4;
      cp_async16(as + rr * C::AS + cc, blk + rr * BS + cc, 16);
    }
    const bool live = c >= 0 && c < r;
    const long long xrow = static_cast<long long>(live ? c : 0) * BS + kk;
    if (vec4) {
      for (int idx = tid; idx < C::KS * NT / 4; idx += C::THREADS) {
        const int rr = idx / (NT / 4), cc = (idx % (NT / 4)) * 4;
        const bool ok = live && col0 + cc < m;
        cp_async16(xs + rr * C::XS + cc,
                   ok ? x + (xrow + rr) * m + col0 + cc : x, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < C::KS * NT; idx += C::THREADS) {
        const int rr = idx / NT, cc = idx % NT;
        const bool ok = live && col0 + cc < m;
        cp_async4(xs + rr * C::XS + cc,
                  ok ? x + (xrow + rr) * m + col0 + cc : x, ok ? 4 : 0);
      }
    }
  };

  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int mf = 0; mf < C::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < C::NF; ++nf)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.0f;

#pragma unroll
  for (int p = 0; p < C::STAGES - 1; ++p) {
    if (p < steps) load(p);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<C::STAGES - 2>();  // this step's stage has landed
    __syncthreads();  // ... for every thread; the oldest stage is free
    if (step + C::STAGES - 1 < steps) load(step + C::STAGES - 1);
    cp_async_commit();
    const float* as = smem + (step % C::STAGES) * C::STAGE_FLOATS;
    const float* xs = as + BS * C::AS;
#pragma unroll
    for (int k8 = 0; k8 < C::KS / 8; ++k8) {
      // MMA k-slot t holds block column k8 * 8 + 2t and slot t + 4 holds
      // 2t + 1, for A and X alike, so A's pairs are one float2 load.
      unsigned a_hi[C::MF][4], a_lo[C::MF][4];
#pragma unroll
      for (int mf = 0; mf < C::MF; ++mf) {
        const int row = (wm * C::MF + mf) * 16 + g;
        const float2 top = *reinterpret_cast<const float2*>(
            as + row * C::AS + k8 * 8 + 2 * t);
        const float2 bot = *reinterpret_cast<const float2*>(
            as + (row + 8) * C::AS + k8 * 8 + 2 * t);
        split_tf32(top.x, a_hi[mf][0], a_lo[mf][0]);
        split_tf32(bot.x, a_hi[mf][1], a_lo[mf][1]);
        split_tf32(top.y, a_hi[mf][2], a_lo[mf][2]);
        split_tf32(bot.y, a_hi[mf][3], a_lo[mf][3]);
      }
      unsigned b_hi[C::NF][2], b_lo[C::NF][2];
#pragma unroll
      for (int nf = 0; nf < C::NF; ++nf) {
        const int n = (wn * C::NF + nf) * 8 + g;
        split_tf32(xs[(k8 * 8 + 2 * t) * C::XS + n], b_hi[nf][0],
                   b_lo[nf][0]);
        split_tf32(xs[(k8 * 8 + 2 * t + 1) * C::XS + n], b_hi[nf][1],
                   b_lo[nf][1]);
      }
      // Three passes over the tiles, small terms first: consecutive
      // MMAs go to different accumulators, so none waits on the last.
#pragma unroll
      for (int mf = 0; mf < C::MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < C::NF; ++nf)
          mma_tf32(acc[mf][nf], a_lo[mf], b_hi[nf]);
#pragma unroll
      for (int mf = 0; mf < C::MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < C::NF; ++nf)
          mma_tf32(acc[mf][nf], a_hi[mf], b_lo[nf]);
#pragma unroll
      for (int mf = 0; mf < C::MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < C::NF; ++nf)
          mma_tf32(acc[mf][nf], a_hi[mf], b_hi[nf]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mf = 0; mf < C::MF; ++mf) {
    const long long row = i * BS + (wm * C::MF + mf) * 16 + g;
#pragma unroll
    for (int nf = 0; nf < C::NF; ++nf) {
      const int col = col0 + (wn * C::NF + nf) * 8 + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cq = col + (q & 1);
        if (cq < m) y[(row + 8 * (q >> 1)) * m + cq] = acc[mf][nf][q];
      }
    }
  }
}

template <int BS, int NT>
cudaError_t launch_spmm(const float* blocks, const int* cols, const float* x,
                        float* y, int r, int s, int m, cudaStream_t stream) {
  using C = Spmm<BS, NT>;
  static bool configured = false;  // the dynamic shared memory above 48 KB
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_kernel<BS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles = (m + NT - 1) / NT;
  const long long grid = static_cast<long long>(r) * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec4 =
      m % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0;
  bsr_spmm_kernel<BS, NT><<<static_cast<int>(grid), C::THREADS,
                            C::SMEM_BYTES, stream>>>(blocks, cols, x, y, r, s,
                                                     m, tiles, vec4);
  return cudaGetLastError();
}

template <int BS>
cudaError_t launch(const float* blocks, const int* cols, const float* x,
                   float* y, int r, int s, int m, cudaStream_t stream) {
  if (m == 1) {
    bsr_spmv_kernel<BS><<<r, spmv_threads<BS>(), 0, stream>>>(
        blocks, cols, x, y, r, s);
    return cudaGetLastError();
  }
  // 8 columns per CTA up to m = 8, else 64 (at m = 128 two 64-column CTAs
  // per block row, two per SM, beat one 128-column CTA per SM).
  if (m <= 8) return launch_spmm<BS, 8>(blocks, cols, x, y, r, s, m, stream);
  return launch_spmm<BS, 64>(blocks, cols, x, y, r, s, m, stream);
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
