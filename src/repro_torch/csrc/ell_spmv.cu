// Sparse matrix-vector product y = A @ x over a padded ELL matrix: two
// entries, x resident and x in slabs.
//
// Replaces the Pallas TPU kernels src/repro/kernels/spmv/kernel.py ::
// ell_spmv (body _spmv_kernel) and ell_spmv_blocked (body
// _spmv_blocked_kernel).  cols (rows, width) int32 and vals (rows,
// width) f32 are row major and contiguous; padding entries hold column 0
// and value 0.  Every column index is below n.  y (rows,) f32.
//
// Rows are balanced before packing (core/loadbalance.py, the paper's
// round-robin law, or a sort by length), so neighbouring rows cost about
// the same.  Each row is taken by a group of `lanes` threads (a power of
// two up to 32, so a group never spans two warps), adjacent lanes on
// adjacent addresses; each accumulates vals[r, w] * x[cols[r, w]] in f32,
// and the group sums its lanes by shuffles.
//
// Bound: bytes.  Each nonzero costs 8 bytes of cols and vals for 2
// operations, far below the H100's ~20 f32 operations per byte, so the
// floor is the nonzeros' bytes over the memory rate.  The gathers from x
// and any padding read are what would break it.
//
// ell_spmv: the whole of x is staged in shared memory, the counterpart
// of the TPU's VMEM-resident x; n * 4 bytes must fit a block's shared
// memory (the wrapper checks).  Given each packed row's length (row_lens,
// the CSR row lengths pack_csr keeps), lane l of row r reads the
// 16-byte vectors l, l + lanes, ... of its row below row_lens[r] (4 cols
// in one int4 load, 4 vals in one float4, streaming past L1) and masks
// the entries of the last vector past the row's end, so no padding entry
// is used and no vector wholly of padding is read: the bytes fall from
// the padded ELL's to the nonzeros' rounded up to 16 bytes.  Without
// row_lens every row runs its full width, as the Pallas kernel does.
// Rows whose width is not a multiple of 4 entries, or arrays not on 16
// bytes, take 4-byte loads.  The launch geometry comes from the matrix
// (kernels/spmv/kernel.py :: launch_geometry): a matrix of few long rows
// gets more lanes a row and blocks as small as one warp, so its rows
// spread over the SMs; a large one a grid of 1024-thread blocks, as many
// as fit on the SMs (x of more than 112 KB leaves room for one), each
// staging x once and walking row blocks with a grid stride.
//
// ell_spmv_blocked: x too large for shared memory, cut in slabs of
// block_cols columns (the TPU kernel streams every slab through VMEM for
// every row block).  A block of 512 threads holds its block_rows rows'
// entries in registers (at most kMaxPerLane per lane) and reads x in one
// of two ways:
//   - x is one slab (n <= block_cols): every block stages it in shared
//     memory, the copy overlapping the loads of its entries, as B7 does,
//     and reads its entries' x from there;
//   - x is several slabs: every entry gathers x[c] directly through the
//     read-only path (__ldg), from L1 or the 50 MB L2 that holds x (4 MB
//     at 1M columns).  No slab is copied, so a slab none of the block's
//     entries falls in costs nothing.
// Both add into one f32 partial sum per lane; y is stored once.  So B8 is
// bound by bytes: the ELL read once, plus one L2 sector per direct gather
// at most (a block's neighbouring gathers share L1 lines and sectors).
// Staging a slab only where a block's entries in it would pay for the
// copy (a per-slab count in shared memory) was measured on one H100 and
// never beat gathering: the copy waits for the entry loads it is decided
// from, while the gathers it saves are mostly L1 hits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kResidentThreads = 1024;
constexpr int kBlockedThreads = 512;
constexpr int kMaxPerLane = 32;
constexpr int kMaxDevices = 64;

// Sums v over the `lanes` threads of a group (lanes a power of two <= 32;
// every thread of the warp takes part).
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, lanes);
  return v;
}

// x[start, start + len) into shared memory, 16 bytes a thread where the
// source is 16-byte aligned (x's allocation is, and start is a multiple
// of 4 when the slab width is).
__device__ __forceinline__ void stage_x(float* xs, const float* x,
                                        long long start, int len) {
  const float* src = x + start;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = len >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(xs);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    head = n4 << 2;
  }
  for (int i = head + threadIdx.x; i < len; i += blockDim.x) xs[i] = src[i];
}

template <int V>
__global__ void __launch_bounds__(kResidentThreads)
    ell_spmv_kernel(const float* __restrict__ x, const int* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int* __restrict__ row_lens, float* __restrict__ y,
                    int rows, int width, int n, int lanes) {
  extern __shared__ __align__(16) float xs[];
  stage_x(xs, x, 0, n);
  __syncthreads();
  const int per_block = blockDim.x / lanes;
  const int g = threadIdx.x / lanes, l = threadIdx.x % lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * per_block;
       r0 < rows; r0 += static_cast<long long>(gridDim.x) * per_block) {
    const long long r = r0 + g;
    float acc = 0.f;
    if (r < rows) {
      const int len = row_lens ? row_lens[r] : width;
      const int* cr = cols + r * width;
      const float* vr = vals + r * width;
      if constexpr (V == 4) {
        const int4* c4 = reinterpret_cast<const int4*>(cr);
        const float4* v4 = reinterpret_cast<const float4*>(vr);
        const int nv = (len + 3) >> 2;
#pragma unroll 2
        for (int i = l; i < nv; i += lanes) {
          const int4 c = __ldcs(c4 + i);
          const float4 v = __ldcs(v4 + i);
          const int rem = len - 4 * i;   // entries of this vector in the row
          acc = fmaf(v.x, xs[c.x], acc);
          if (rem > 1) acc = fmaf(v.y, xs[c.y], acc);
          if (rem > 2) acc = fmaf(v.z, xs[c.z], acc);
          if (rem > 3) acc = fmaf(v.w, xs[c.w], acc);
        }
      } else {
#pragma unroll 4
        for (int w = l; w < len; w += lanes)
          acc = fmaf(__ldcs(vr + w), xs[__ldcs(cr + w)], acc);
      }
    }
    acc = group_sum(acc, lanes);
    if (l == 0 && r < rows) y[r] = acc;
  }
}

template <int E>
__global__ void __launch_bounds__(kBlockedThreads)
    ell_spmv_blocked_kernel(const float* __restrict__ x,
                            const int* __restrict__ cols,
                            const float* __restrict__ vals,
                            float* __restrict__ y, int rows, int width, int n,
                            int lanes, int block_cols) {
  extern __shared__ __align__(16) float xs[];   // x, when it is one slab
  const int per_block = kBlockedThreads / lanes;
  const int g = threadIdx.x / lanes, l = threadIdx.x % lanes;
  const long long r = static_cast<long long>(blockIdx.x) * per_block + g;
  int c[E];
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int w = l + e * lanes;
    const bool ok = r < rows && w < width;
    c[e] = ok ? cols[r * width + w] : -1;   // -1: no entry
    v[e] = ok ? vals[r * width + w] : 0.f;
  }
  float acc = 0.f;
  if (n <= block_cols) {
    stage_x(xs, x, 0, n);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (c[e] >= 0) acc = fmaf(v[e], xs[c[e]], acc);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (c[e] >= 0) acc = fmaf(v[e], __ldg(x + c[e]), acc);
  }
  acc = group_sum(acc, lanes);
  if (l == 0 && r < rows) y[r] = acc;
}

// Lets a kernel take up to the device's opt-in shared memory per block;
// set once per kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

bool lanes_ok(int lanes) {
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
}

template <int E>
int launch_blocked(const float* x, const int* cols, const float* vals,
                   float* y, int rows, int width, int n, int lanes,
                   int block_cols, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = ell_spmv_blocked_kernel<E>;
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kBlockedThreads / lanes;
  const long long blocks = (static_cast<long long>(rows) + per_block - 1) /
                           per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = n <= block_cols ? n * sizeof(float) : 0;
  kernel<<<static_cast<unsigned>(blocks), kBlockedThreads, smem, stream>>>(
      x, cols, vals, y, rows, width, n, lanes, block_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes.  x: n floats; cols, vals: (rows, width)
// contiguous; y: rows floats.  Return the CUDA error of the launch (0 on
// success).

// row_lens: rows ints in [0, width], or null (every row runs its full
// width).  threads: a block's threads (a multiple of 32 up to 1024, of
// lanes a row); grid: blocks, each staging all of x (n * 4 bytes of
// shared memory) and walking threads / lanes rows at a time.
extern "C" int ell_spmv(const float* x, const int* cols, const float* vals,
                        const int* row_lens, float* y, int rows, int width,
                        int n, int lanes, int threads, int grid,
                        void* stream) {
  if (rows < 1 || width < 1 || n < 1 || grid < 1 || !lanes_ok(lanes) ||
      threads < 32 || threads > kResidentThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  static std::atomic<bool> done4[kMaxDevices], done1[kMaxDevices];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = n * sizeof(float);
  if (vec) {
    cudaError_t err = allow_smem(ell_spmv_kernel<4>, done4);
    if (err != cudaSuccess) return static_cast<int>(err);
    ell_spmv_kernel<4><<<grid, threads, smem, s>>>(x, cols, vals, row_lens,
                                                    y, rows, width, n, lanes);
  } else {
    cudaError_t err = allow_smem(ell_spmv_kernel<1>, done1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ell_spmv_kernel<1><<<grid, threads, smem, s>>>(x, cols, vals, row_lens,
                                                    y, rows, width, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

// block_rows = 512 / lanes rows per block; each lane holds
// ceil(width / lanes) <= 32 entries; slabs of block_cols columns.
extern "C" int ell_spmv_blocked(const float* x, const int* cols,
                                const float* vals, float* y, int rows,
                                int width, int n, int lanes, int block_cols,
                                void* stream) {
  if (rows < 1 || width < 1 || n < 1 || block_cols < 1 || !lanes_ok(lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (width + lanes - 1) / lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_lane <= 1)
    return launch_blocked<1>(x, cols, vals, y, rows, width, n, lanes,
                             block_cols, s);
  if (per_lane <= 2)
    return launch_blocked<2>(x, cols, vals, y, rows, width, n, lanes,
                             block_cols, s);
  if (per_lane <= 4)
    return launch_blocked<4>(x, cols, vals, y, rows, width, n, lanes,
                             block_cols, s);
  if (per_lane <= 8)
    return launch_blocked<8>(x, cols, vals, y, rows, width, n, lanes,
                             block_cols, s);
  if (per_lane <= 16)
    return launch_blocked<16>(x, cols, vals, y, rows, width, n, lanes,
                              block_cols, s);
  if (per_lane <= kMaxPerLane)
    return launch_blocked<kMaxPerLane>(x, cols, vals, y, rows, width, n,
                                       lanes, block_cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
