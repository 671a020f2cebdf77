// The shared body of the single-query GQA decode-attention kernels
// (decode_attention.cu, paged_decode_attention.cu,
// quantized_decode_attention.cu, paged_quantized_decode_attention.cu).
//
// Work: the g = Hq/Hkv query rows of KV head h of sequence b read the same
// K and V rows, so the cache is streamed once per (b, h) for the whole
// group, never per query head.  No key at or past a row's length (clamped
// to [0, rows]) is loaded.  Scores, maxima, sums and accumulators stay in
// f32 (online softmax); a row of length 0 writes zeros.
//
// Bound: device-memory bytes.  Each K/V element is read once and used for
// 2*g multiply-adds (g = 5 for Qwen3-14B), far below the H100's ~20 f32
// operations per byte, so the design aims at many bytes in flight on
// every SM and at no chain of latencies between them.
//
// Split keys (flash-decoding).  The grid is (split, b * Hkv + h): split s
// owns keys [s * span, (s + 1) * span) of its row, so a row of n keys runs
// on ceil(n / span) blocks spread over the SMs.  The span is an argument
// of each call (Args::span, any span >= 1: a block's walk stops at the
// end of its span wherever that falls in a round of 64 keys), the
// counterpart of the TPU kernel's block_k; the caller picks it (the
// wrappers' default, or the decode tuner's plan for the cache depth).
// The grid is sized from the shapes and the span alone (the cache's
// rows), never from the lengths, so the host reads nothing back; a block
// whose span starts at or past its row's length has no keys and exits
// without writing, and block 0 of a row of length 0 writes its zeros.
// The bounds depend on key positions only, not on the rows, the page size
// or the layout.
//
// Inside a block: eight warps, each walking its own 8-key tiles of the
// span (warp w takes tiles w, w + 8, ...) with no block barrier.  A warp
// copies its next tile of K and V rows into its own two-stage ring with
// 16-byte cp.async copies while it computes the current one.  Four lanes
// share a key for q.k (each takes every fourth 16-byte chunk of the row,
// q read from shared memory as a broadcast), a shuffle adds their parts;
// the tile's max is three shuffles per query row and the running max, sum
// and correction stay in registers; each lane then owns four output
// columns for p.v, reading the tile's probabilities from a per-warp array.
// Shared-memory rows are padded to an odd number of 16-byte units, so
// lanes reading the same chunk of eight keys hit distinct banks.  The
// group is a template bound (4, 5, 8 or 16 query rows in registers, q
// zero past g), so the walk is straight-line code with no per-row branch
// and small enough for the instruction cache.
//
// Combine inside the kernel.  The eight warps' (max, sum, accumulator) are
// merged through shared memory.  A row with one split writes its output
// there.  Otherwise each block writes its partial (m, l, acc per query
// row) to a workspace, fences, and takes a ticket from an atomic counter
// of its (b, h); the block that draws the last ticket reads the row's
// partials in ascending split order and writes m = max m_i,
// l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l, then resets the
// counter to 0 for the next call.  No float atomics: the result does not
// depend on the order in which blocks finish.
//
// Two template parameters say where key row t of (b, h) lives and what it
// holds; only the tile copy and the shared-memory reads depend on them:
//   kPaged = false: a contiguous cache, row (b, t) at b*s0 + t*s1 + h*sh.
//   kPaged = true:  a pool of pages shared by every sequence; row (b, t) is
//                   row t % page_size of pool page pages[b, t / page_size],
//                   clamped to [0, num_pages) as the TPU kernel clamps it.
//                   A key at or past length[b] is never read, so the -1
//                   entries past a slot's last page are never reached, and
//                   the copy is per key row, so any page_size >= 1 works.
//   KT = float or bf16: the cache element itself.
//   KT = int8_t: a code, with one f32 scale per (row, KV head) in a parallel
//                array: q.k is taken over the codes and scaled once per
//                key, and the V scale is folded into the key's probability.
// The keys are read in the same order and combined by the same arithmetic
// whatever the layout, so a paged cache gives bitwise the result of the
// same rows laid out contiguously.
//
// Known gap: a block pays a fixed cost outside its stream of copies (its
// length and q loads, the first copy's wait, the fence and the ticket), so
// at 32,768 keys, with 128 splits of 256 keys a row, the kernel reads
// about 2 TB/s; a longer span pays it fewer times and fills fewer SMs
// (PERF.md), and a persistent grid that walks several splits per block
// would hide it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 8;              // keys per warp tile
constexpr int kLanesPerKey = 32 / kTileKeys;
constexpr int kStages = 2;                // per-warp cp.async ring
constexpr int kMaxGroup = 16;             // query rows per KV head
constexpr int kMaxDh = 128;               // four output columns per lane
constexpr int kCombineChunk = 128;        // split weights held at once
constexpr float kNegInf = -1e30f;

template <typename KT>
constexpr bool kQuant = std::is_same<KT, int8_t>::value;

// x rounded to the cache type: q meets the keys in it, as the TPU kernel
// feeds it to the MXU; the int8 kernels keep q in f32.
template <typename KT>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<KT, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(x));
  return x;
}

// Four consecutive cache elements as f32 (int8: the codes themselves).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  return make_float4(__uint_as_float(lo << 16),
                     __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16),
                     __uint_as_float(hi & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return bf16x4(u.x, u.y);
}
__device__ __forceinline__ float4 int8x4(int u) {
  return make_float4(static_cast<float>(static_cast<int8_t>(u)),
                     static_cast<float>(static_cast<int8_t>(u >> 8)),
                     static_cast<float>(static_cast<int8_t>(u >> 16)),
                     static_cast<float>(static_cast<int8_t>(u >> 24)));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  return int8x4(*reinterpret_cast<const int*>(p));
}

// The 16-byte chunk u of a cache row as 16 / sizeof(KT) f32 values, four
// at a time.
template <typename KT>
__device__ __forceinline__ float4 unpack(const uint4& u, int i);
template <>
__device__ __forceinline__ float4 unpack<float>(const uint4& u, int) {
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                     __uint_as_float(u.z), __uint_as_float(u.w));
}
template <>
__device__ __forceinline__ float4 unpack<__nv_bfloat16>(const uint4& u,
                                                        int i) {
  return i == 0 ? bf16x4(u.x, u.y) : bf16x4(u.z, u.w);
}
template <>
__device__ __forceinline__ float4 unpack<int8_t>(const uint4& u, int i) {
  const uint32_t w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  return int8x4(static_cast<int>(w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Strides, in elements, of a cache array: its outer index (the sequence,
// or the pool page), its row and its KV head.
struct Layout {
  long long s0, s1, sh;
};

// The page table of a paged cache: (batch, max_pages) int32, -1 = none.
struct Pages {
  const int* table;
  int max_pages, page_size, num_pages;
};

template <typename KT>
struct Args {
  const void* q;             // (B, Hq, dh), strides (q_sb, q_sh, 1)
  void* out;                 // contiguous (B, Hq, dh), q's type
  const KT* k;
  const KT* v;
  Layout kl, vl;
  const float* ks;           // int8 only: the scales, one per (row, head)
  const float* vs;
  Layout ksl, vsl;
  const int* lengths;        // (B,) int32
  Pages pages;               // paged only
  int q_bf16;                // q and out: bfloat16 (1) or float32 (0)
  float* part;               // workspace: split partials (part_floats)
  int* tickets;              // (B * Hkv,) int32, 0 between calls
  int hkv, g, dh;
  int rows;                  // rows a sequence holds: L or pages * page_size
  int span;                  // keys per split, >= 1
  int nsplit;                // splits of the grid: split_count(rows, span)
  long long q_sb, q_sh;
  float scale;
};

// Splits of the grid for a cache of ``rows`` rows in spans of ``span``
// keys (at least one, so a cache of no rows still writes its zeros).
__host__ __device__ constexpr int split_count(int rows, int span) {
  return rows > span ? static_cast<int>(
                           (static_cast<long long>(rows) + span - 1) / span)
                     : 1;
}

// Floats of the workspace: per (b, h) and split, the g x dh accumulator
// and the g (m, l) pairs.
__host__ __device__ constexpr long long part_floats(int batch, int hkv, int g,
                                                   int dh, int rows,
                                                   int span) {
  return static_cast<long long>(batch) * hkv * split_count(rows, span) * g *
         (dh + 2);
}

// The outer index and row of key t of sequence b.
template <bool kPaged>
__device__ __forceinline__ void locate(const Pages& pg, int b, int t,
                                       int& outer, int& row) {
  if constexpr (kPaged) {
    const int j = t / pg.page_size;
    const int p = pg.table[static_cast<long long>(b) * pg.max_pages + j];
    outer = min(max(p, 0), pg.num_pages - 1);
    row = t - j * pg.page_size;
  } else {
    outer = b;
    row = t;
  }
}

// A cache row in shared memory: padded to an odd number of 16-byte units.
__host__ __device__ constexpr int row_stride(int dh, int elt) {
  return ((dh * elt / 16) | 1) * 16;
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory.  During the walk: each warp's ring of K and V tiles (and,
// for int8, their scales); after it, in the same bytes, the warps' partials
// and the weights of the splits being combined.  Then, apart, the f32 q
// rows (kG of them, zero past g) and each warp's tile of probabilities.
__host__ __device__ constexpr size_t walk_bytes(int dh, int elt, bool quant) {
  return static_cast<size_t>(kWarps) * kStages * 2 * kTileKeys *
         (row_stride(dh, elt) + (quant ? 4 : 0));
}
__host__ __device__ constexpr size_t merge_bytes(int dh, int kg) {
  return align16(4ull *
                 (kWarps * kg * (dh + 2) + kg * (kCombineChunk + 1)));
}
__host__ __device__ constexpr size_t smem_bytes(int dh, int kg, int elt,
                                                bool quant) {
  return (walk_bytes(dh, elt, quant) > merge_bytes(dh, kg)
              ? walk_bytes(dh, elt, quant)
              : merge_bytes(dh, kg)) +
         4ull * (kg * dh + kWarps * kg * kTileKeys);
}

// Query row r of (b, h), or the output row, as f32 / q's type.
template <typename KT>
__device__ __forceinline__ float load_q(const Args<KT>& a, long long i) {
  return a.q_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(a.q)[i])
                  : static_cast<const float*>(a.q)[i];
}
template <typename KT>
__device__ __forceinline__ void store_out(const Args<KT>& a, long long i,
                                          float x) {
  if (a.q_bf16)
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(a.out)[i] = x;
}

// KT: type of the cache.  kG: query rows the registers hold, g rounded up
// to an instantiated group (4, 5, 8, 16); rows past g hold q = 0 and are
// never written, so the walk has no per-row branch.
template <typename KT, bool kPaged, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Args<KT> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  constexpr int kElems = 16 / sizeof(KT);   // elements per 16-byte chunk
  const int dh = a.dh, g = a.g;
  const int s = blockIdx.x;                 // split
  const int bh = blockIdx.y;                // b * Hkv + h
  const int b = bh / a.hkv, h = bh - b * a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(a.lengths[b], 0), a.rows);
  const int span = a.span;
  const int nact = static_cast<int>(
      (static_cast<long long>(len) + span - 1) / span);  // splits with keys
  const long long ob = static_cast<long long>(bh) * g * dh;  // output row 0
  if (s >= nact) {
    if (s == 0)
      for (int i = tid; i < g * dh; i += kThreads) store_out(a, ob + i, 0.f);
    return;
  }
  const int begin = s * span;               // < len: s < nact
  const int end = len - begin > span ? begin + span : len;

  const int stride = row_stride(dh, sizeof(KT));
  const int tile = kTileKeys * stride;
  const int walk = static_cast<int>(walk_bytes(dh, sizeof(KT), kQuant<KT>));
  const int merge = static_cast<int>(merge_bytes(dh, kG));
  unsigned char* ring = smem + warp * kStages * 2 * tile;
  float* sc = reinterpret_cast<float*>(smem + kWarps * kStages * 2 * tile) +
              warp * kStages * 2 * kTileKeys;
  float* q_s = reinterpret_cast<float*>(smem + (walk > merge ? walk : merge));
  float* p_s = q_s + kG * dh + warp * kG * kTileKeys;   // [kG][kTileKeys]

  const long long q0 = b * a.q_sb + static_cast<long long>(h) * g * a.q_sh;
  for (int i = tid; i < kG * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[i] = r < g ? round_to<KT>(load_q(a, q0 + r * a.q_sh + d)) : 0.f;
  }

  // Lane roles.  Copy: lane (ck, cj) copies chunk ck of keys cj, cj + kpp,
  // ...  q.k: lane (j, part) takes chunks part, part + 4, ... of key j.
  // p.v: lane owns columns 4 * lane .. 4 * lane + 3.
  const int nch = dh * static_cast<int>(sizeof(KT)) / 16;
  const int kpp = 32 / nch;
  const int ck = lane % nch, cj = lane / nch;
  const int j = lane % kTileKeys, part = lane / kTileKeys;

  auto copy = [&](int t0, int st) {
    const int nk = min(kTileKeys, end - t0);
    unsigned char* kd = ring + st * 2 * tile;
    unsigned char* vd = kd + tile;
    if (cj < kpp) {
      for (int jj = cj; jj < nk; jj += kpp) {
        int outer, row;
        locate<kPaged>(a.pages, b, t0 + jj, outer, row);
        const KT* kr = a.k + outer * a.kl.s0 + row * a.kl.s1 + h * a.kl.sh;
        const KT* vr = a.v + outer * a.vl.s0 + row * a.vl.s1 + h * a.vl.sh;
        cp_async16(kd + jj * stride + ck * 16, kr + ck * kElems);
        cp_async16(vd + jj * stride + ck * 16, vr + ck * kElems);
      }
    }
    if constexpr (kQuant<KT>) {
      if (lane < 2 * nk) {
        const int jj = lane < nk ? lane : lane - nk;
        int outer, row;
        locate<kPaged>(a.pages, b, t0 + jj, outer, row);
        if (lane < nk)
          cp_async4(sc + st * 2 * kTileKeys + jj,
                    a.ks + outer * a.ksl.s0 + row * a.ksl.s1 + h * a.ksl.sh);
        else
          cp_async4(sc + st * 2 * kTileKeys + kTileKeys + jj,
                    a.vs + outer * a.vsl.s0 + row * a.vsl.s1 + h * a.vsl.sh);
      }
    }
  };

  float m[kG], l[kG];
  float4 acc[kG];
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int first = begin + warp * kTileKeys;
  constexpr int kStep = kWarps * kTileKeys;
  if (first < end) copy(first, 0);
  cp_async_commit();
  __syncthreads();                       // q_s is written
  int st = 0;
  for (int t0 = first; t0 < end; t0 += kStep, st ^= 1) {
    const int nk = min(kTileKeys, end - t0);
    if (t0 + kStep < end) copy(t0 + kStep, st ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_one();         // this lane's copies of tile t0
    __syncwarp();                        // ... and every lane's
    const unsigned char* kt = ring + st * 2 * tile;
    const unsigned char* vt = kt + tile;

    // 1. q.k: four lanes per key, every fourth 16-byte chunk each.  A row
    // past the tile's end holds stale bytes; its score is masked below.
    float sco[kG];
#pragma unroll
    for (int r = 0; r < kG; ++r) sco[r] = 0.f;
    const unsigned char* krow = kt + j * stride;
#pragma unroll 2
    for (int c = part; c < nch; c += kLanesPerKey) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow + c * 16);
#pragma unroll
      for (int i = 0; i < kElems / 4; ++i) {
        const float4 k4 = unpack<KT>(u, i);
        const float* qc = q_s + c * kElems + 4 * i;
#pragma unroll
        for (int r = 0; r < kG; ++r)
          sco[r] = dot4(*reinterpret_cast<const float4*>(qc + r * dh), k4,
                        sco[r]);
      }
    }
    float kscale = a.scale, vscale = 1.f;
    if constexpr (kQuant<KT>) {
      kscale *= sc[st * 2 * kTileKeys + j];
      vscale = sc[st * 2 * kTileKeys + kTileKeys + j];
    }

    // 2. Online softmax, in registers.  After the shuffles every lane of
    // key j holds its scores; a key past the end scores -1e30, and its
    // probability is exactly 0.
#pragma unroll
    for (int r = 0; r < kG; ++r) {
      float x = sco[r];
#pragma unroll
      for (int o = kTileKeys; o < 32; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      x = j < nk ? x * kscale : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = kTileKeys / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      const float p = j < nk ? expf(x - m_new) : 0.f;
      m[r] = m_new;
      l[r] = l[r] * corr + (part == 0 ? p : 0.f);
      acc[r].x *= corr;
      acc[r].y *= corr;
      acc[r].z *= corr;
      acc[r].w *= corr;
      if (part == 0) p_s[r * kTileKeys + j] = j < nk ? p * vscale : 0.f;
    }
    __syncwarp();

    // 3. acc += p.v: lane owns four columns.  A key past the end has p = 0
    // and reads the tile's last valid row, so stale bytes never enter.
    if (4 * lane < dh) {
      const KT* vcol = reinterpret_cast<const KT*>(vt) + 4 * lane;
      const int se = stride / static_cast<int>(sizeof(KT));
#pragma unroll
      for (int jj = 0; jj < kTileKeys; jj += 4) {
        float4 v4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v4[u] = load4(vcol + min(jj + u, nk - 1) * se);
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(p_s + r * kTileKeys + jj);
          axpy4(p4.x, v4[0], acc[r]);
          axpy4(p4.y, v4[1], acc[r]);
          axpy4(p4.z, v4[2], acc[r]);
          axpy4(p4.w, v4[3], acc[r]);
        }
      }
    }
    __syncwarp();                        // the stage is free again
  }

  // Merge the warps through shared memory (the ring is free).
#pragma unroll
  for (int r = 0; r < kG; ++r) l[r] = warp_sum(l[r]);
  __syncthreads();
  float* w_m = reinterpret_cast<float*>(smem);    // [warps][kG]
  float* w_l = w_m + kWarps * kG;                 // [warps][kG]
  float* w_acc = w_l + kWarps * kG;               // [warps][kG][dh]
  float* c_m = w_acc + kWarps * kG * dh;          // [kG]
  float* c_w = c_m + kG;                          // [kG][kCombineChunk]
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    if (lane == 0) {
      w_m[warp * kG + r] = m[r];
      w_l[warp * kG + r] = l[r];
    }
    if (4 * lane < dh)
      *reinterpret_cast<float4*>(w_acc + (warp * kG + r) * dh + 4 * lane) =
          acc[r];
  }
  __syncthreads();

  const long long bs = static_cast<long long>(bh) * a.nsplit + s;
  float* p_acc = a.part;                 // [B*Hkv][nsplit][g][dh]
  float* p_ml = a.part + static_cast<long long>(gridDim.y) * a.nsplit * g *
                             dh;         // [B*Hkv][nsplit][g][2]
  for (int e = tid; e < g * dh; e += kThreads) {
    const int r = e / dh;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * kG + r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(w_m[w * kG + r] - mx);
      lsum = fmaf(w_l[w * kG + r], wt, lsum);
      o = fmaf(w_acc[(w * kG + r) * dh + e - r * dh], wt, o);
    }
    if (nact == 1) {
      store_out(a, ob + e, o / fmaxf(lsum, 1e-30f));
    } else {
      p_acc[bs * g * dh + e] = o;
      if (e == r * dh) {
        p_ml[(bs * g + r) * 2] = mx;
        p_ml[(bs * g + r) * 2 + 1] = lsum;
      }
    }
  }
  if (nact == 1) return;

  // The last block of (b, h) to finish combines the row's partials.
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(a.tickets + bh, 1);
  __syncthreads();
  if (ticket != nact - 1) return;
  __threadfence();
  const float* r_acc = p_acc + static_cast<long long>(bh) * a.nsplit * g * dh;
  const float* r_ml = p_ml + static_cast<long long>(bh) * a.nsplit * g * 2;
  for (int r = warp; r < g; r += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < nact; i += 32)
      mx = fmaxf(mx, __ldcg(r_ml + (i * g + r) * 2));
    mx = warp_max(mx);
    if (lane == 0) c_m[r] = mx;
  }
  constexpr int kPer = (kG * kMaxDh + kThreads - 1) / kThreads;
  float o[kPer], lsum[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) o[k] = lsum[k] = 0.f;
  for (int i0 = 0; i0 < nact; i0 += kCombineChunk) {
    const int n = min(kCombineChunk, nact - i0);
    __syncthreads();                     // c_m written; c_w free
    for (int x = tid; x < g * n; x += kThreads) {
      const int r = x / n, i = x - r * n;
      c_w[r * kCombineChunk + i] =
          expf(__ldcg(r_ml + ((i0 + i) * g + r) * 2) - c_m[r]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < g * dh) {
        const int r = e / dh;
        for (int i = 0; i < n; ++i) {
          const float wt = c_w[r * kCombineChunk + i];
          lsum[k] = fmaf(__ldcg(r_ml + ((i0 + i) * g + r) * 2 + 1), wt,
                         lsum[k]);
          o[k] = fmaf(__ldcg(r_acc + static_cast<long long>(i0 + i) * g * dh +
                             e),
                      wt, o[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    if (e < g * dh) store_out(a, ob + e, o[k] / fmaxf(lsum[k], 1e-30f));
  }
  if (tid == 0) atomicExch(a.tickets + bh, 0);
}

constexpr int kMaxDevices = 64;

// Lets the kernel take the shared memory of its largest shape.  The
// attribute belongs to the current device and never changes, so it is set
// once per instantiation and device instead of on every launch of a
// decode step.
template <typename KT, bool kPaged, int kG>
cudaError_t allow_max_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      decode_kernel<KT, kPaged, kG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxDh, kG, sizeof(KT), kQuant<KT>)));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// The arguments every layout shares; an entry adds scales and pages.
template <typename KT>
Args<KT> make_args(const void* q, void* out, int q_bf16, const void* k,
                   const void* v, const void* lengths, void* part,
                   void* tickets, int hkv, int g, int dh, int rows, int span,
                   long long q_sb, long long q_sh, Layout kl, Layout vl,
                   float scale) {
  Args<KT> a{};
  a.q = q;
  a.out = out;
  a.q_bf16 = q_bf16;
  a.k = static_cast<const KT*>(k);
  a.v = static_cast<const KT*>(v);
  a.kl = kl;
  a.vl = vl;
  a.lengths = static_cast<const int*>(lengths);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.hkv = hkv;
  a.g = g;
  a.dh = dh;
  a.rows = rows;
  a.span = span;
  a.nsplit = split_count(rows, span);
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.scale = scale;
  return a;
}

// Checks the limits every entry shares, and that the workspace holds
// ``have`` >= part_floats floats for this call's span; 0 if the launch may
// go ahead.
inline int check_shape(int batch, int hkv, int g, int dh, int kv_elt,
                       int rows, int span, long long have) {
  if (g < 1 || g > kMaxGroup || dh < 8 || dh > kMaxDh || dh % 8 ||
      (dh * kv_elt) % 16 || batch < 0 || hkv < 1 || rows < 0 || span < 1 ||
      static_cast<long long>(batch) * hkv > 65535 ||
      have < part_floats(batch, hkv, g, dh, rows, span))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename KT, bool kPaged, int kG>
int launch_group(const Args<KT>& a, int batch, cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<KT, kPaged, kG>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(a.dh, kG, sizeof(KT), kQuant<KT>);
  decode_kernel<KT, kPaged, kG>
      <<<dim3(a.nsplit, batch * a.hkv), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation per group bound: Danube's g = 4, Qwen3-14B's 5, and 8
// and 16 for the rest.
template <typename KT, bool kPaged>
int launch(const Args<KT>& a, int batch, cudaStream_t stream) {
  if (batch == 0) return 0;
  if (a.g <= 4) return launch_group<KT, kPaged, 4>(a, batch, stream);
  if (a.g == 5) return launch_group<KT, kPaged, 5>(a, batch, stream);
  if (a.g <= 8) return launch_group<KT, kPaged, 8>(a, batch, stream);
  return launch_group<KT, kPaged, kMaxGroup>(a, batch, stream);
}

}  // namespace

