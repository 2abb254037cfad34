// The masked PCG iteration's vector and scalar work, for the single-system
// chunked PCG (solvers/cg.py), around the caller's own operator product
// and preconditioner apply.  An iteration is
//
//   Ap = matvec(A, p);   xr: frozen = done | k >= max_iter (kept for the
//                            iteration); alpha = frozen ? 0 : rz / (Ap.p);
//                            where not frozen x = x + alpha p,
//                            r = r - alpha Ap, res = (r.r) / b.b and
//                            done |= res < rtol
//   z = apply_m(M, r);   p:  beta = frozen ? 0 : r.z / rz; where not
//                            frozen p = z + beta p, rz = r.z, k += 1 and
//                            stop = done | k >= max_iter
//
// x, r and p are updated in place; rz is carried from one iteration to the
// next, so r.z is taken once an iteration.  The scalars live on the device
// (vals: rz, alpha, beta, b.b, res in the vectors' type; flags: k, done,
// frozen, stop and a ticket, int32), so no launch reads the card on the
// host and a chunk of iterations can be captured in a CUDA graph.
//
// Replaces no TPU kernel.  PyTorch ran the iteration as ~31 small kernels
// (cuBLAS dots, broadcast multiplies, adds and torch.where over 0-dim
// tensors): about 32 passes over an n-vector, where the mathematics needs
// 13 (p.Ap 2; x and r with r.r 6; r.z 2; p 3).
//
// What bounds it on an H100 (3350 GB/s): bytes, 13 n-vectors an iteration
// (872 MB, 0.26 ms at 256^3 float32); below ~16K entries, the launches.
//
// Design.  Where the wrapper's grid G is above 1 (n above
// ops/pcg_iteration.py's SINGLE_BLOCK_MAX_N) the iteration is four
// launches of G blocks of 256 threads, each thread taking entries i,
// i + 256 G, ... with four loads in flight: the p.Ap dot, the x and r
// update with r.r, the r.z dot and the p update.  A dot's blocks write
// their partial sums to scratch; the block that takes the last ticket
// (atomicAdd after __threadfence) sums them in block order, resets the
// ticket and writes the scalars.  The order of every sum is fixed by n, so
// a call gives the same bits every time, eagerly or replayed from a
// graph.  At G = 1 one block of 1024 threads does p.Ap and the update in
// one launch, and r.z and the p update in another: two launches an
// iteration.  A frozen iteration reads nothing but its flags, and writes
// alpha and beta 0 (as the plain version does).
//
// Rounding: every product and sum of the updates is rounded on its own
// (__fmul_rn, __fadd_rn: never contracted), as PyTorch's separate kernels
// round them.  The dots are summed in S, the vectors' own precision, as
// the reference's float32 dots and cuBLAS's are: only the order of the
// sums differs.  (Float64 sums for float32 vectors move unpreconditioned
// float32 CG off the reference's counts: on an H100 they took one case of
// the frames split to 160 iterations, where the reference takes 172 and
// float32 sums 171; its float64 count is 141.)
//
// Layout: x, r, p, Ap, z (n,) contiguous of one dtype S, float32 or
// float64, on one device; vals (>= 5) and work (>= grid) of that dtype,
// flags (>= 5) int32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // a block of the multi-block kernels
constexpr int kSingleThreads = 1024;  // the block of the one-block kernels
constexpr int kMaxGrid = 1024;        // partial sums the scratch holds
constexpr int kUnroll = 4;            // entries in flight a thread

enum Val { kRz = 0, kAlpha = 1, kBeta = 2, kBb = 3, kRes = 4 };
enum Flag { kK = 0, kDone = 1, kFrozen = 2, kStop = 3, kTicket = 4 };

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// The sum of v over the block in a fixed order; the result in thread 0.
template <int Threads, typename S>
__device__ __forceinline__ S block_sum(S v, S* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, o);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by the block's previous sum
  if (lane == 0) {
    red[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < Threads / 32 ? red[lane] : S(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o);
    }
  }
  return v;
}

// This thread's share of a . b: entries first, first + stride, ...
template <typename S>
__device__ __forceinline__ S dot_share(const S* __restrict__ a,
                                       const S* __restrict__ b, int n,
                                       int first, int stride) {
  S acc = S(0);
  int i = first;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    S va[kUnroll];
    S vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      va[u] = a[i + u * stride];
      vb[u] = b[i + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc += va[u] * vb[u];
    }
  }
  for (; i < n; i += stride) {
    acc += a[i] * b[i];
  }
  return acc;
}

// x = x + alpha p, r = r - alpha Ap on this thread's entries; returns its
// share of r.r.
template <typename S>
__device__ __forceinline__ S update_xr_share(
    S* __restrict__ x, S* __restrict__ r, const S* __restrict__ p,
    const S* __restrict__ ap, S alpha, int n, int first, int stride) {
  S acc = S(0);
  int i = first;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    S vx[kUnroll];
    S vr[kUnroll];
    S vp[kUnroll];
    S va[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vx[u] = x[i + u * stride];
      vr[u] = r[i + u * stride];
      vp[u] = p[i + u * stride];
      va[u] = ap[i + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vx[u] = add_rn(vx[u], mul_rn(alpha, vp[u]));
      vr[u] = sub_rn(vr[u], mul_rn(alpha, va[u]));
      x[i + u * stride] = vx[u];
      r[i + u * stride] = vr[u];
      acc += vr[u] * vr[u];
    }
  }
  for (; i < n; i += stride) {
    const S xi = add_rn(x[i], mul_rn(alpha, p[i]));
    const S ri = sub_rn(r[i], mul_rn(alpha, ap[i]));
    x[i] = xi;
    r[i] = ri;
    acc += ri * ri;
  }
  return acc;
}

// p = z + beta p on this thread's entries.
template <typename S>
__device__ __forceinline__ void update_p_share(S* __restrict__ p,
                                               const S* __restrict__ z,
                                               S beta, int n, int first,
                                               int stride) {
  int i = first;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    S vp[kUnroll];
    S vz[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vp[u] = p[i + u * stride];
      vz[u] = z[i + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[i + u * stride] = add_rn(vz[u], mul_rn(beta, vp[u]));
    }
  }
  for (; i < n; i += stride) {
    p[i] = add_rn(z[i], mul_rn(beta, p[i]));
  }
}

// The block's partial sum (thread 0's v) to the scratch.  Returns true in
// every thread of the block that arrives last, which then holds in thread
// 0's v the sum of all the blocks' partials, taken in block order, and has
// reset the ticket for the next launch.
template <typename S>
__device__ __forceinline__ bool grid_sum(S& v, S* work, int* ticket, S* red,
                                         int* last) {
  if (threadIdx.x == 0) {
    work[blockIdx.x] = v;
    __threadfence();
    *last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!*last) {
    return false;
  }
  __threadfence();
  S s = S(0);
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    s += __ldcg(work + b);
  }
  v = block_sum<kThreads>(s, red);
  if (threadIdx.x == 0) {
    *ticket = 0;
  }
  return true;
}

// frozen = done | k >= max_iter, taken at the start of an iteration.
__device__ __forceinline__ bool frozen_now(const int* flags, int max_iter) {
  return flags[kDone] != 0 || flags[kK] >= max_iter;
}

// res = (r.r) / b.b; done once it is below rtol.
template <typename S>
__device__ __forceinline__ void finish_xr(S* vals, int* flags, S rr,
                                          double rtol) {
  const S res = rr / vals[kBb];
  vals[kRes] = res;
  if (res < static_cast<S>(rtol)) {
    flags[kDone] = 1;
  }
}

// beta = rz' / rz, rz = rz', k += 1, stop = done | k >= max_iter.
template <typename S>
__device__ __forceinline__ S finish_p(S* vals, int* flags, S rz_new,
                                      int max_iter) {
  const S beta = rz_new / vals[kRz];
  vals[kBeta] = beta;
  vals[kRz] = rz_new;
  const int k = flags[kK] + 1;
  flags[kK] = k;
  flags[kStop] = flags[kDone] != 0 || k >= max_iter;
  return beta;
}

// -- the multi-block kernels -------------------------------------------

template <typename S>
__global__ void __launch_bounds__(kThreads)
pcg_pap_kernel(const S* __restrict__ p, const S* __restrict__ ap, S* vals,
               int* flags, S* work, int n, int max_iter) {
  __shared__ S red[kThreads / 32];
  __shared__ int last;
  if (frozen_now(flags, max_iter)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      flags[kFrozen] = 1;
      vals[kAlpha] = S(0);
    }
    return;
  }
  S v = block_sum<kThreads>(
      dot_share(p, ap, n, blockIdx.x * kThreads + threadIdx.x,
                gridDim.x * kThreads),
      red);
  if (grid_sum(v, work, flags + kTicket, red, &last) && threadIdx.x == 0) {
    flags[kFrozen] = 0;
    vals[kAlpha] = vals[kRz] / v;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
pcg_xr_kernel(S* __restrict__ x, S* __restrict__ r, const S* __restrict__ p,
              const S* __restrict__ ap, S* vals, int* flags, S* work, int n,
              double rtol) {
  __shared__ S red[kThreads / 32];
  __shared__ int last;
  if (flags[kFrozen] != 0) {
    return;
  }
  S v = block_sum<kThreads>(
      update_xr_share(x, r, p, ap, vals[kAlpha], n,
                      blockIdx.x * kThreads + threadIdx.x,
                      gridDim.x * kThreads),
      red);
  if (grid_sum(v, work, flags + kTicket, red, &last) && threadIdx.x == 0) {
    finish_xr(vals, flags, v, rtol);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
pcg_rz_kernel(const S* __restrict__ r, const S* __restrict__ z, S* vals,
              int* flags, S* work, int n, int max_iter) {
  __shared__ S red[kThreads / 32];
  __shared__ int last;
  if (flags[kFrozen] != 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      vals[kBeta] = S(0);
    }
    return;
  }
  S v = block_sum<kThreads>(
      dot_share(r, z, n, blockIdx.x * kThreads + threadIdx.x,
                gridDim.x * kThreads),
      red);
  if (grid_sum(v, work, flags + kTicket, red, &last) && threadIdx.x == 0) {
    finish_p(vals, flags, v, max_iter);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
pcg_p_kernel(S* __restrict__ p, const S* __restrict__ z, const S* vals,
             const int* flags, int n) {
  if (flags[kFrozen] != 0) {
    return;
  }
  update_p_share(p, z, vals[kBeta], n, blockIdx.x * kThreads + threadIdx.x,
                 gridDim.x * kThreads);
}

// -- the one-block kernels (small n) -----------------------------------

template <typename S>
__global__ void __launch_bounds__(kSingleThreads)
pcg_xr_block_kernel(S* __restrict__ x, S* __restrict__ r,
                    const S* __restrict__ p, const S* __restrict__ ap,
                    S* vals, int* flags, int n, int max_iter, double rtol) {
  __shared__ S red[kSingleThreads / 32];
  __shared__ S alpha;
  const bool frozen = frozen_now(flags, max_iter);
  if (threadIdx.x == 0) {
    flags[kFrozen] = frozen;
  }
  if (frozen) {
    if (threadIdx.x == 0) {
      vals[kAlpha] = S(0);
    }
    return;
  }
  const S pap = block_sum<kSingleThreads>(
      dot_share(p, ap, n, threadIdx.x, kSingleThreads), red);
  if (threadIdx.x == 0) {
    alpha = vals[kRz] / pap;
    vals[kAlpha] = alpha;
  }
  __syncthreads();
  const S rr = block_sum<kSingleThreads>(
      update_xr_share(x, r, p, ap, alpha, n, threadIdx.x, kSingleThreads),
      red);
  if (threadIdx.x == 0) {
    finish_xr(vals, flags, rr, rtol);
  }
}

template <typename S>
__global__ void __launch_bounds__(kSingleThreads)
pcg_p_block_kernel(const S* __restrict__ r, const S* __restrict__ z,
                   S* __restrict__ p, S* vals, int* flags, int n,
                   int max_iter) {
  __shared__ S red[kSingleThreads / 32];
  __shared__ S beta;
  if (flags[kFrozen] != 0) {
    if (threadIdx.x == 0) {
      vals[kBeta] = S(0);
    }
    return;
  }
  const S rz = block_sum<kSingleThreads>(
      dot_share(r, z, n, threadIdx.x, kSingleThreads), red);
  if (threadIdx.x == 0) {
    beta = finish_p(vals, flags, rz, max_iter);
  }
  __syncthreads();
  update_p_share(p, z, beta, n, threadIdx.x, kSingleThreads);
}

bool bad_shape(int n, int grid) {
  return n < 1 || grid < 1 || grid > kMaxGrid;
}

template <typename S>
int launch_xr(void* x, void* r, const void* p, const void* ap, void* vals,
              void* flags, void* work, int n, int grid, int max_iter,
              double rtol, void* stream) {
  if (bad_shape(n, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  S* xs = static_cast<S*>(x);
  S* rs = static_cast<S*>(r);
  const S* ps = static_cast<const S*>(p);
  const S* aps = static_cast<const S*>(ap);
  S* v = static_cast<S*>(vals);
  int* f = static_cast<int*>(flags);
  S* w = static_cast<S*>(work);
  if (grid == 1) {
    pcg_xr_block_kernel<S><<<1, kSingleThreads, 0, s>>>(
        xs, rs, ps, aps, v, f, n, max_iter, rtol);
    return static_cast<int>(cudaGetLastError());
  }
  pcg_pap_kernel<S><<<grid, kThreads, 0, s>>>(ps, aps, v, f, w, n, max_iter);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  pcg_xr_kernel<S><<<grid, kThreads, 0, s>>>(xs, rs, ps, aps, v, f, w, n,
                                              rtol);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_p(const void* r, const void* z, void* p, void* vals, void* flags,
             void* work, int n, int grid, int max_iter, void* stream) {
  if (bad_shape(n, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const S* rs = static_cast<const S*>(r);
  const S* zs = static_cast<const S*>(z);
  S* ps = static_cast<S*>(p);
  S* v = static_cast<S*>(vals);
  int* f = static_cast<int*>(flags);
  S* w = static_cast<S*>(work);
  if (grid == 1) {
    pcg_p_block_kernel<S><<<1, kSingleThreads, 0, s>>>(rs, zs, ps, v, f, n,
                                                        max_iter);
    return static_cast<int>(cudaGetLastError());
  }
  pcg_rz_kernel<S><<<grid, kThreads, 0, s>>>(rs, zs, v, f, w, n, max_iter);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  pcg_p_kernel<S><<<grid, kThreads, 0, s>>>(ps, zs, v, f, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, p, Ap, vals, flags, work, n, grid, max_iter, rtol, stream: the
// p.Ap dot and the x and r update (see the header).
extern "C" int dp_pcg_xr_f32(void* x, void* r, const void* p, const void* ap,
                             void* vals, void* flags, void* work, int n,
                             int grid, int max_iter, double rtol,
                             void* stream) {
  return launch_xr<float>(x, r, p, ap, vals, flags, work, n, grid, max_iter,
                          rtol, stream);
}

extern "C" int dp_pcg_xr_f64(void* x, void* r, const void* p, const void* ap,
                             void* vals, void* flags, void* work, int n,
                             int grid, int max_iter, double rtol,
                             void* stream) {
  return launch_xr<double>(x, r, p, ap, vals, flags, work, n, grid, max_iter,
                           rtol, stream);
}

// r, z, p, vals, flags, work, n, grid, max_iter, stream: the r.z dot and
// the p update.
extern "C" int dp_pcg_p_f32(const void* r, const void* z, void* p,
                            void* vals, void* flags, void* work, int n,
                            int grid, int max_iter, void* stream) {
  return launch_p<float>(r, z, p, vals, flags, work, n, grid, max_iter,
                         stream);
}

extern "C" int dp_pcg_p_f64(const void* r, const void* z, void* p,
                            void* vals, void* flags, void* work, int n,
                            int grid, int max_iter, void* stream) {
  return launch_p<double>(r, z, p, vals, flags, work, n, grid, max_iter,
                          stream);
}
