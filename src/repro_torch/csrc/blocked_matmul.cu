// Blocked dense matrix product with a fused epilogue:
// C = act(A @ B + bias), f32 accumulation, one cast to the output type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul/kernel.py ::
// blocked_matmul (body _matmul_kernel).  A (M, K) and B (K, N) are row
// major with row strides lda and ldb; bias is an f32 row of N (or null);
// C (M, N) is f32 or bf16 with row stride ldc.  Activations: 0 none,
// 1 relu, 2 gelu (the tanh approximation, jax.nn.gelu's default),
// 3 silu, 4 tanh.
//
// Work: one block owns one (y, x) tile of C and walks K in z-deep steps,
// the paper's eq. 2 tiling (core/tiling.py :: solve_hopper picks the
// tile).  A (y, z) and B (z, x) tiles are staged in shared memory by
// cp.async, two stages deep, so the next step's copy overlaps this
// step's products; each shared-memory row is padded by 16 bytes so the
// fragment reads are free of bank conflicts.  The C tile stays in f32
// registers for the whole K walk and is written once, bias and
// activation applied on the way out.  Ragged M, N and K need no padded
// copies: rows and columns past the edge are zero-filled by the copy
// (cp.async with a source size of 0) and never stored.
//
// Bound: operations.  A (y, x) tile does y * x / (y + x) multiply-adds
// per element it loads (43 for 128 x 256), above the H100's ~295 bf16
// operations per byte only through L2 reuse across blocks, so large
// products are limited by the tensor cores' rate.  bf16 operands run on
// the tensor cores (mma.sync m16n8k16, f32 accumulators): each warp owns
// a (y / WM, x / WN) part of the tile, reads A by ldmatrix and B by
// transposed ldmatrix.  f32 operands run exact FMAs on the CUDA cores,
// never TF32: each thread owns an 8 x 8 part of the tile, its rows and
// columns strided by y / 8 and x / 8 so a warp's reads hit distinct
// banks or broadcast.  bf16 operands that TMA can read (16-byte aligned
// base and row strides) run blocked_matmul_wgmma.cu instead, at the
// tensor cores' rate; this mma.sync kernel takes the other bf16 operands
// (kernels/matmul/kernel.py :: design).
//
// Built for the tiles of core/tiling.py :: HOPPER_TILES: (y, x) in
// {64, 128, 256}^2 without 256 x 256 (its accumulators would fill the
// register file), z in {32, 64}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kStages = 2;

struct Params {
  const void* a;
  const void* b;
  const float* bias;   // N floats, or null
  void* c;
  int m, n, k;
  long long lda, ldb, ldc;   // row strides in elements
  int out_bf16, act, vec;    // vec: 16-byte copies are legal
};

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major operand
// into shared memory at row stride COLS + 16 bytes; elements at or past
// (nr, nc) are zero-filled.  With vec, 16-byte cp.async copies (the
// caller guarantees aligned rows and nc a multiple of 16 bytes, so a
// chunk is wholly inside or wholly outside); otherwise element by
// element, stored directly.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int r0, int c0, int nr, int nc,
                                          bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kLd = COLS + kPer;
  if (vec) {
    constexpr int kChunks = COLS / kPer;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
      const int row = i / kChunks;
      const int col = (i - row * kChunks) * kPer;
      const int r = r0 + row, c = c0 + col;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + row * kLd + col, ok ? src + r * ld + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int row = i / COLS;
      const int col = i - row * COLS;
      const int r = r0 + row, c = c0 + col;
      dst[row * kLd + col] = (r < nr && c < nc) ? src[r * ld + c] : zero<T>();
    }
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:
      return fmaxf(v, 0.f);
    case 2: {
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    case 3:
      return v / (1.f + expf(-v));
    case 4:
      return tanhf(v);
    default:
      return v;
  }
}

// The epilogue of one element: bias, activation, one cast, masked store.
__device__ __forceinline__ void store_out(const Params& p, int row, int col,
                                          float v) {
  if (row >= p.m || col >= p.n) return;
  if (p.bias) v += p.bias[col];
  v = activate(v, p.act);
  const long long off = row * p.ldc + col;
  if (p.out_bf16)
    static_cast<bf16*>(p.c)[off] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.c)[off] = v;
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row major) * b (16 x 8, column major); bf16 in, f32 out.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, int BK>
constexpr size_t bf16_smem() {
  return kStages * (BM * (BK + 8) + BK * (BN + 8)) * sizeof(bf16);
}

// WM x WN warps; warp (wm, wn) owns rows [wm * BM / WM, ..) and columns
// [wn * BN / WN, ..) of the tile.  Fragment layouts (PTX ISA,
// mma.m16n8k16): lane = 4 * gr + tq; C rows gr and gr + 8, columns 2 tq
// and 2 tq + 1.
template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) mm_bf16_kernel(const Params p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWtm = BM / WM, kWtn = BN / WN;
  constexpr int kMi = kWtm / 16, kNi = kWtn / 8;
  constexpr int kLda = BK + 8, kLdb = BN + 8;
  static_assert(kWtm % 16 == 0 && kWtn % 16 == 0 && BK % 16 == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);    // [kStages][BM][kLda]
  bf16* b_s = a_s + kStages * BM * kLda;        // [kStages][BK][kLdb]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int gr = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
  const bool vec = p.vec != 0;
  const int nk = (p.k + BK - 1) / BK;

  float acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_tile<bf16, BM, BK, kThreads>(a_s, a, p.lda, m0, 0, p.m, p.k, vec);
  load_tile<bf16, BK, BN, kThreads>(b_s, b, p.ldb, 0, n0, p.k, p.n, vec);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int s = (kt + 1) & 1;
      load_tile<bf16, BM, BK, kThreads>(a_s + s * BM * kLda, a, p.lda, m0,
                                        (kt + 1) * BK, p.m, p.k, vec);
      load_tile<bf16, BK, BN, kThreads>(b_s + s * BK * kLdb, b, p.ldb,
                                        (kt + 1) * BK, n0, p.k, p.n, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of step kt landed
    __syncthreads();      // ... and every thread's
    const bf16* as = a_s + (kt & 1) * BM * kLda;
    const bf16* bs = b_s + (kt & 1) * BK * kLdb;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned af[kMi][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i)
        ldmatrix_x4(af[i], as + (wm * kWtm + i * 16 + mr + (mi & 1) * 8) *
                                    kLda + kk * 16 + (mi >> 1) * 8);
      unsigned bfr[kNi][2];
#pragma unroll
      for (int j = 0; j < kNi / 2; ++j) {
        unsigned t[4];
        ldmatrix_x4_trans(t, bs + (kk * 16 + mr + (mi & 1) * 8) * kLdb +
                                 wn * kWtn + j * 16 + (mi >> 1) * 8);
        bfr[2 * j][0] = t[0];
        bfr[2 * j][1] = t[1];
        bfr[2 * j + 1][0] = t[2];
        bfr[2 * j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j)
          mma16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    __syncthreads();   // the stage is free for step kt + 2
  }

#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    const int row = m0 + wm * kWtm + i * 16 + gr;
#pragma unroll
    for (int j = 0; j < kNi; ++j) {
      const int col = n0 + wn * kWtn + j * 8 + 2 * tq;
      store_out(p, row, col, acc[i][j][0]);
      store_out(p, row, col + 1, acc[i][j][1]);
      store_out(p, row + 8, col, acc[i][j][2]);
      store_out(p, row + 8, col + 1, acc[i][j][3]);
    }
  }
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------

template <int BM, int BN, int BK>
constexpr size_t f32_smem() {
  return kStages * (BM * (BK + 4) + BK * (BN + 4)) * sizeof(float);
}

// Thread (ty, tx) owns rows ty + i * BM / 8 and columns tx + j * BN / 8,
// i, j < 8, of the tile.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(BM * BN / 64) mm_f32_kernel(const Params p) {
  constexpr int kThreads = BM * BN / 64;
  constexpr int kTx = BN / 8, kTy = BM / 8;
  constexpr int kLda = BK + 4, kLdb = BN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);   // [kStages][BM][kLda]
  float* b_s = a_s + kStages * BM * kLda;        // [kStages][BK][kLdb]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  const bool vec = p.vec != 0;
  const int nk = (p.k + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tile<float, BM, BK, kThreads>(a_s, a, p.lda, m0, 0, p.m, p.k, vec);
  load_tile<float, BK, BN, kThreads>(b_s, b, p.ldb, 0, n0, p.k, p.n, vec);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int s = (kt + 1) & 1;
      load_tile<float, BM, BK, kThreads>(a_s + s * BM * kLda, a, p.lda, m0,
                                         (kt + 1) * BK, p.m, p.k, vec);
      load_tile<float, BK, BN, kThreads>(b_s + s * BK * kLdb, b, p.ldb,
                                         (kt + 1) * BK, n0, p.k, p.n, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = a_s + (kt & 1) * BM * kLda;
    const float* bs = b_s + (kt & 1) * BK * kLdb;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[(ty + i * kTy) * kLda + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[kk * kLdb + tx + j * kTx];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_out(p, m0 + ty + i * kTy, n0 + tx + j * kTx, acc[i][j]);
}

// --------------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Lets an instantiation take its dynamic shared memory; set once per
// instantiation and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int BM, int BN, int BK, int WM, int WN>
int launch_bf16(const Params& p, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  constexpr size_t smem = bf16_smem<BM, BN, BK>();
  auto kernel = mm_bf16_kernel<BM, BN, BK, WM, WN>;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_f32(const Params& p, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  constexpr size_t smem = f32_smem<BM, BN, BK>();
  auto kernel = mm_f32_kernel<BM, BN, BK>;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  kernel<<<grid, BM * BN / 64, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WM, int WN>
int launch(const Params& p, int z, bool is_bf16, cudaStream_t s) {
  if (z == 32)
    return is_bf16 ? launch_bf16<BM, BN, 32, WM, WN>(p, s)
                   : launch_f32<BM, BN, 32>(p, s);
  if (z == 64)
    return is_bf16 ? launch_bf16<BM, BN, 64, WM, WN>(p, s)
                   : launch_f32<BM, BN, 64>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry, bound with ctypes.  a: (m, k) row-major, row stride lda; b:
// (k, n), row stride ldb; both float32 (is_bf16 0) or both bfloat16
// (is_bf16 1).  bias: n floats or null.  c: (m, n), row stride ldc,
// float32 (out_bf16 0) or bfloat16 (out_bf16 1).  act: 0 none, 1 relu,
// 2 gelu (tanh), 3 silu, 4 tanh.  vec: every row of a and b starts on 16
// bytes and k and n are multiples of 16 bytes of elements.  (y, x, z):
// one of the built tiles.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int blocked_matmul(const void* a, const void* b, const float* bias,
                              void* c, int m, int n, int k, long long lda,
                              long long ldb, long long ldc, int y, int x,
                              int z, int is_bf16, int out_bf16, int act,
                              int vec, void* stream) {
  if (m < 1 || n < 1 || k < 1 || act < 0 || act > 4 ||
      (m + y - 1) / y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.a = a;
  p.b = b;
  p.bias = bias;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.out_bf16 = out_bf16 != 0;
  p.act = act;
  p.vec = vec != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b16 = is_bf16 != 0;
  if (y == 64 && x == 64) return launch<64, 64, 2, 2>(p, z, b16, s);
  if (y == 64 && x == 128) return launch<64, 128, 2, 2>(p, z, b16, s);
  if (y == 64 && x == 256) return launch<64, 256, 2, 4>(p, z, b16, s);
  if (y == 128 && x == 64) return launch<128, 64, 2, 2>(p, z, b16, s);
  if (y == 128 && x == 128) return launch<128, 128, 2, 4>(p, z, b16, s);
  if (y == 128 && x == 256) return launch<128, 256, 2, 4>(p, z, b16, s);
  if (y == 256 && x == 64) return launch<256, 64, 4, 2>(p, z, b16, s);
  if (y == 256 && x == 128) return launch<256, 128, 4, 2>(p, z, b16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a launch of tile (y, x, z) in bf16 (is_bf16 1)
// or f32, in bytes; -1 for a tile not built.
extern "C" long long blocked_matmul_smem(int y, int x, int z, int is_bf16) {
  const bool b16 = is_bf16 != 0;
#define BUILT(Y, X)                                           \
  if (y == Y && x == X) {                                     \
    if (z == 32)                                              \
      return b16 ? bf16_smem<Y, X, 32>() : f32_smem<Y, X, 32>(); \
    if (z == 64)                                              \
      return b16 ? bf16_smem<Y, X, 64>() : f32_smem<Y, X, 64>(); \
  }
  BUILT(64, 64)
  BUILT(64, 128)
  BUILT(64, 256)
  BUILT(128, 64)
  BUILT(128, 128)
  BUILT(128, 256)
  BUILT(256, 64)
  BUILT(256, 128)
#undef BUILT
  return -1;
}
