// Blocked dense matrix product on Hopper's tensor cores, wgmma fed by TMA:
// C = act(A @ B + bias) for bf16 A and B, f32 accumulation, one cast to
// the output type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul/kernel.py ::
// blocked_matmul (body _matmul_kernel) for bf16 operands that TMA can
// read: a 16-byte aligned base and row strides that are multiples of 16
// bytes (kernels/matmul/kernel.py :: design routes them here; other bf16
// operands run the mma.sync kernel of blocked_matmul.cu, f32 its CUDA-core
// kernel).  A (M, K) and B (K, N) are row major with row strides lda and
// ldb; bias is an f32 row of N (or null); C (M, N) is f32 or bf16 with
// row stride ldc.  Activations as in blocked_matmul.cu: 0 none, 1 relu,
// 2 gelu (tanh approximation), 3 silu, 4 tanh.
//
// Bound: operations.  A (y, x) tile does y * x / (y + x) multiply-adds
// per element it loads (85 for 128 x 256), so large products are held by
// the tensor cores' rate, which only wgmma fed from shared memory
// reaches.  The design, for the tiles of core/tiling.py :: HOPPER_TILES:
//
// - A ring of S stages in shared memory, each an A (y, z) box and x / 64
//   B (z, 64) boxes, unpadded and swizzled as TMA writes them, with a
//   "full" and an "empty" mbarrier per stage.  S is as many as a block's
//   232,448 bytes hold (4 for the 48 KB stages of 128 x 256 x 64; at least
//   3 for every built tile): core/tiling.py :: hopper_smem_bytes is this
//   layout, byte for byte.
// - One producer warpgroup gives up its registers (setmaxnreg) and one
//   of its threads issues every copy: cp.async.bulk.tensor.2d of the A box
//   (K-major: z columns of y rows; the 128-byte swizzle at z = 64, the
//   64-byte swizzle at z = 32, whose 64-byte rows it fits) and of the B
//   boxes (B is (K, N) row major, so MN-major: 64 columns of z rows in
//   the 128-byte swizzle), into the stage its empty barrier has released.
// - Consumer warpgroups (one for 64-row tiles, else two) each own y / C
//   rows of the C tile across all x columns: 64 or 128 rows, at most 128
//   f32 accumulators a thread.  Per stage a consumer issues wgmma
//   m64nXk16 (X = x) for each 64-row piece and 16-deep step, A from a
//   K-major descriptor and B from an MN-major one (the transpose bit; the
//   second 64-column box as the leading byte offset, as flash_attention.cu
//   reads V), commits them as one group and waits until only that group
//   is in flight: the stage of the previous group is then released.  So
//   the products of step k are queued before those of step k - 1 retire.
// - A persistent grid: each block walks output tiles t = blockIdx.x,
//   blockIdx.x + gridDim.x, ... in a grouped order (8 row panels at a time,
//   so neighbouring blocks share A and B panels in L2).  The producer runs
//   on into the next tile's stages while the consumers store this one.
//   The grid is min(tiles, SMs) blocks.
// - Ragged M, N and K need no padded copies: TMA fills rows and columns
//   past the edge with zeros, and the epilogue masks its stores.  The
//   epilogue adds the bias, applies the activation and casts once,
//   straight from the accumulator fragments, storing column pairs
//   (bf16x2 or float2) where the row stride is even.
//
// Tensor maps are built on the host per call from the strides, through
// the driver entry point the runtime hands out (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSmemLimit = 232448;   // a block's opt-in shared memory
constexpr int kAlignSlack = 1024;    // the ring starts on 1024 bytes
constexpr int kGroupM = 8;           // row panels walked together
constexpr int kMaxDevices = 64;

// The shared memory and warps of one (BM, BN, BK) tile.
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int kM = BM, kN = BN, kK = BK;
  static constexpr int kConsumers = BM == 64 ? 1 : 2;
  static constexpr int kRowsPerWg = BM / kConsumers;   // 64 or 128
  static constexpr int kMs = kRowsPerWg / 64;          // 64-row pieces
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBoxes = BN / 64;               // 64-column B boxes
  static constexpr int kBoxBytes = BK * 64 * 2;
  static constexpr int kBBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // each stage has two 8-byte mbarriers
  static constexpr int kStages =
      (kSmemLimit - kAlignSlack) / (kStageBytes + 16);
  static constexpr int kSmem = kStages * (kStageBytes + 16) + kAlignSlack;
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(BK == 32 || BK == 64, "z is 32 or 64");
  static_assert(BN % 64 == 0 && BN <= 256 && BM % 64 == 0, "tile");
};

struct Params {
  const float* bias;   // N floats, or null
  void* c;
  int m, n, k;
  long long ldc;
  int out_bf16, act;
};

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The (c0 column, c1 row) box of a 2-D tensor map into shared memory,
// completing on ``bar``; elements past the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         unsigned long long* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled operand at ``p``: start
// address, leading and stride byte offsets (16-byte units), layout type
// (1: 128-byte swizzle, 2: 64-byte swizzle).
__device__ __forceinline__ unsigned long long desc(const void* p,
                                                   unsigned lbo, unsigned sbo,
                                                   unsigned long long layout) {
  return static_cast<unsigned long long>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32) | (layout << 62);
}

// Pins the order of accumulator reads and writes against the
// asynchronous wgmma statements around it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>   // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, f32) = a (64 x 16) b (16 x 64) + (scale_d ? d : 0); a
// K-major and b MN-major (the transpose bit) in shared memory.
__device__ __forceinline__ void wgmma_64(float (&d)[32], int scale_d,
                                         unsigned long long desc_a,
                                         unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) + (scale_d ? d : 0); a
// K-major and b MN-major (the transpose bit) in shared memory.
__device__ __forceinline__ void wgmma_128(float (&d)[64], int scale_d,
                                          unsigned long long desc_a,
                                          unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, f32) = a (64 x 16) b (16 x 256) + (scale_d ? d : 0); a
// K-major and b MN-major (the transpose bit) in shared memory.
__device__ __forceinline__ void wgmma_256(float (&d)[128], int scale_d,
                                          unsigned long long desc_a,
                                          unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], int scale_d,
                                      unsigned long long desc_a,
                                      unsigned long long desc_b) {
  if constexpr (N == 64) wgmma_64(d, scale_d, desc_a, desc_b);
  if constexpr (N == 128) wgmma_128(d, scale_d, desc_a, desc_b);
  if constexpr (N == 256) wgmma_256(d, scale_d, desc_a, desc_b);
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

// Output tile t of a (tiles_m, tiles_n) grid in the grouped order: kGroupM
// row panels at a time, down the panels, then across the columns.
__device__ __forceinline__ void raster(int t, int tiles_m, int tiles_n,
                                       int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int group = t / per_group;
  const int first = group * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int r = t - group * per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// Fragment layout (PTX ISA, wgmma .m64nNk16): warp w of a consumer owns
// rows 16 w + gr and 16 w + gr + 8 of each 64-row piece (lane = 4 gr +
// tq); d[4 i + e] is column 8 i + 2 tq + (e & 1) of row gr (e < 2) or
// gr + 8.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Tile<BM, BN, BK>::kThreads, 1)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const Params p) {
  using T = Tile<BM, BN, BK>;
  constexpr int kS = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* a_s = reinterpret_cast<bf16*>(base);   // [kS][BM][BK]
  bf16* b_s = reinterpret_cast<bf16*>(base + kS * T::kABytes);
  // b_s: [kS][kBoxes][BK][64]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(base + kS * T::kStageBytes);
  unsigned long long* empty = full + kS;

  const int tiles_m = (p.m + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kConsumers) {
    // ---- producer: one thread issues every copy ----
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == T::kConsumers * 128) {
      int s = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        raster(t, tiles_m, tiles_n, tm, tn);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);   // the first round: at once
          mbar_expect_tx(&full[s], T::kStageBytes);
          tma_load(a_s + s * BM * BK, &ta, &full[s], kt * BK, tm * BM);
#pragma unroll
          for (int j = 0; j < T::kBoxes; ++j)
            tma_load(b_s + (s * T::kBoxes + j) * BK * 64, &tb, &full[s],
                     tn * BN + 64 * j, kt * BK);
          if (++s == kS) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer wg: rows [wg * kRowsPerWg, ..) of each C tile ----
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t128 = threadIdx.x % 128;
    const int warp = t128 >> 5, lane = t128 & 31;
    const int gr = lane >> 2, tq = lane & 3;
    // A: K-major, 64-byte rows (z = 32) or 128-byte rows (z = 64), 8-row
    // swizzle atoms; B: MN-major boxes of 64 columns.
    constexpr unsigned kASbo = 8 * BK * 2;
    constexpr unsigned long long kALayout = BK == 64 ? 1 : 2;
    float acc[T::kMs][BN / 2];
    int s = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      raster(t, tiles_m, tiles_n, tm, tn);
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[s], phase);
#pragma unroll
        for (int ms = 0; ms < T::kMs; ++ms) fence_acc(acc[ms]);
        wgmma_fence();
        const bf16* as = a_s + s * BM * BK + wg * T::kRowsPerWg * BK;
        const bf16* bs = b_s + s * T::kBoxes * BK * 64;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int ms = 0; ms < T::kMs; ++ms)
            wgmma<BN>(acc[ms], (kt | kk) != 0,
                      desc(as + ms * 64 * BK + kk * 16, 16, kASbo, kALayout),
                      desc(bs + kk * 16 * 64, T::kBoxBytes, 1024, 1));
        wgmma_commit();
#pragma unroll
        for (int ms = 0; ms < T::kMs; ++ms) fence_acc(acc[ms]);
        wgmma_wait<1>();   // the previous stage's products are in
#pragma unroll
        for (int ms = 0; ms < T::kMs; ++ms) fence_acc(acc[ms]);
        if (kt > 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == kS) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int ms = 0; ms < T::kMs; ++ms) fence_acc(acc[ms]);
      mbar_arrive(&empty[prev]);

      // Epilogue: bias, activation, one cast, masked stores of pairs.
      const int row0 = tm * BM + wg * T::kRowsPerWg + warp * 16 + gr;
      const bool pairs = (p.ldc & 1) == 0;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = tn * BN + 8 * i + 2 * tq;
        if (col >= p.n) continue;
        const bool two = col + 1 < p.n;
        float b0 = 0.f, b1 = 0.f;
        if (p.bias) {
          b0 = p.bias[col];
          if (two) b1 = p.bias[col + 1];
        }
#pragma unroll
        for (int ms = 0; ms < T::kMs; ++ms)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + ms * 64 + h * 8;
            if (row >= p.m) continue;
            const float v0 = activate(acc[ms][4 * i + 2 * h] + b0, p.act);
            const float v1 =
                activate(acc[ms][4 * i + 2 * h + 1] + b1, p.act);
            const long long off = row * p.ldc + col;
            if (p.out_bf16) {
              bf16* c = static_cast<bf16*>(p.c) + off;
              if (two && pairs) {
                *reinterpret_cast<__nv_bfloat162*>(c) =
                    __floats2bfloat162_rn(v0, v1);
              } else {
                c[0] = __float2bfloat16_rn(v0);
                if (two) c[1] = __float2bfloat16_rn(v1);
              }
            } else {
              float* c = static_cast<float*>(p.c) + off;
              if (two && pairs) {
                *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
              } else {
                c[0] = v0;
                if (two) c[1] = v1;
              }
            }
          }
      }
    }
  }
}

// --------------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major bf16 operand with a row stride of ``ld``
// elements, read in boxes of (box_rows, box_cols).
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                int rows, int cols, long long ld, int box_rows, int box_cols,
                CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

struct Launch {
  const void* a;
  const void* b;
  long long lda, ldb;
  Params p;
  int sms;    // blocks at most: one per SM, each walking tiles
  cudaStream_t stream;
};

template <typename T>
int launch(const Launch& l) {
  constexpr int BM = T::kM, BN = T::kN, BK = T::kK;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, encode, l.a, l.p.m, l.p.k, l.lda, BM, BK,
                  BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&tb, encode, l.b, l.p.k, l.p.n, l.ldb, BK, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = mm_wgmma_kernel<BM, BN, BK>;
  cudaError_t err = allow_smem(kernel, T::kSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((l.p.m + BM - 1) / BM) *
                          ((l.p.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = l.sms < tiles ? l.sms : tiles;
  kernel<<<static_cast<unsigned>(blocks), T::kThreads, T::kSmem, l.stream>>>(
      ta, tb, l.p);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn(Tile<y, x, z>{}) for a built tile; -1 for any other.
template <typename Fn>
long long with_tile(int y, int x, int z, Fn&& fn) {
#define BUILT(Y, X)                                        \
  if (y == Y && x == X) {                                  \
    if (z == 32) return fn(Tile<Y, X, 32>{});              \
    if (z == 64) return fn(Tile<Y, X, 64>{});              \
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

}  // namespace

// C entry, bound with ctypes.  a: (m, k) bf16, row stride lda; b: (k, n)
// bf16, row stride ldb; both 16-byte aligned with row strides of a
// multiple of 16 bytes.  bias: n floats or null.  c: (m, n), row stride
// ldc, float32 (out_bf16 0) or bfloat16 (out_bf16 1).  act: 0 none,
// 1 relu, 2 gelu (tanh), 3 silu, 4 tanh.  (y, x, z): one of the built
// tiles.  sms: the device's SM count; min(tiles, sms) blocks are launched,
// each walking the output tiles (persistent).
// Returns the CUDA error of the launch (0 on success).
extern "C" int blocked_matmul_wgmma(const void* a, const void* b,
                                    const float* bias, void* c, int m, int n,
                                    int k, long long lda, long long ldb,
                                    long long ldc, int y, int x, int z,
                                    int out_bf16, int act, int sms,
                                    void* stream) {
  if (m < 1 || n < 1 || k < 1 || act < 0 || act > 4 || sms < 1 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || (lda * 2) % 16 ||
      (ldb * 2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{};
  l.a = a;
  l.b = b;
  l.lda = lda;
  l.ldb = ldb;
  l.p.bias = bias;
  l.p.c = c;
  l.p.m = m;
  l.p.n = n;
  l.p.k = k;
  l.p.ldc = ldc;
  l.p.out_bf16 = out_bf16 != 0;
  l.p.act = act;
  l.sms = sms;
  l.stream = static_cast<cudaStream_t>(stream);
  const long long err = with_tile(y, x, z, [&](auto t) -> long long {
    return launch<decltype(t)>(l);
  });
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue)
                 : static_cast<int>(err);
}

// Dynamic shared memory of a launch of tile (y, x, z), in bytes; -1 for a
// tile not built.
extern "C" long long blocked_matmul_wgmma_smem(int y, int x, int z) {
  return with_tile(y, x, z, [](auto t) -> long long {
    return decltype(t)::kSmem;
  });
}
