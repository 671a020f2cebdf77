// The shared body of the single-query GQA decode-attention kernels
// (decode_attention.cu, paged_decode_attention.cu,
// quantized_decode_attention.cu, paged_quantized_decode_attention.cu).
//
// Work: for every (sequence b, KV head h) the g = Hq/Hkv query rows of that
// head read the same K and V rows, so one block owns one (b, h) and streams
// each of its K/V rows once for the whole group -- the cache is never
// repeated per query head.  The block stops at min(length[b], rows): no key
// past a slot's length is loaded.  Scores, running max, running sum and the
// accumulator stay in f32 (online softmax); a slot of length 0 writes zeros.
//
// Bound: device-memory bytes.  Each K/V element is read once and used for
// 2*g multiply-adds (g = 5 for Qwen3-14B), far below the H100's ~20 f32
// operations per byte.  So the design keeps many bytes in flight: tiles of
// 64 keys of K and V are copied to shared memory with 16-byte cp.async
// copies, two tiles deep, so the copy of tile t + 1 runs while tile t is
// computed from shared memory.  With one block per SM there is little
// latency hiding, so the products read four elements per shared-memory
// load: q rows (f32) are shared by every key, and each key's dot is split
// between two threads.
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
//                array; the element is float(code) * scale, formed in f32
//                registers from the codes and scales in shared memory.
// The keys are read in the same order and combined by the same arithmetic
// whatever the layout, so a paged cache gives bitwise the result of the
// same rows laid out contiguously.
//
// Known gap: B*Hkv blocks (32 at batch 4) leave most of the 132 SMs idle,
// and each block walks its row's tiles one after another; splitting the keys
// of a row across blocks with a combine pass (flash-decoding) is the fix.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;      // keys per tile; two threads per key
constexpr int kMaxGroup = 16;      // query rows per KV head
constexpr int kMaxDh = 128;        // one thread per output column
constexpr float kNegInf = -1e30f;

template <typename KT>
constexpr bool kQuant = std::is_same<KT, int8_t>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One cache element as f32; ``s`` is the row's scale, used by int8 only.
__device__ __forceinline__ float deq(float x, float) { return x; }
__device__ __forceinline__ float deq(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float deq(int8_t x, float s) {
  return static_cast<float>(x) * s;
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

// Four consecutive cache elements as f32: one 16-byte (f32), 8-byte (bf16)
// or 4-byte (int8, times the row's scale) shared-memory load.
__device__ __forceinline__ float4 load4(const float* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, float) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p, float s) {
  const int u = *reinterpret_cast<const int*>(p);
  return make_float4(deq(static_cast<int8_t>(u), s),
                     deq(static_cast<int8_t>(u >> 8), s),
                     deq(static_cast<int8_t>(u >> 16), s),
                     deq(static_cast<int8_t>(u >> 24), s));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
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
  int hkv, g, dh;
  int rows;                  // rows a sequence can hold: L, or max_pages * page_size
  long long q_sb, q_sh;
  float scale;
};

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

// Copy keys [t0, t0 + nk) of one (b, h) row of K and V (and their scales)
// into a stage.
template <bool kPaged, typename KT>
__device__ __forceinline__ void load_tile(KT* k_dst, KT* v_dst, float* ks_dst,
                                          float* vs_dst, const Args<KT>& a,
                                          int b, int h, int t0, int nk) {
  constexpr int kPerChunk = 16 / sizeof(KT);
  const int dh = a.dh;
  const int chunks = dh / kPerChunk;
  for (int c = threadIdx.x; c < nk * chunks; c += kThreads) {
    const int j = c / chunks;
    const int o = (c - j * chunks) * kPerChunk;
    int outer, row;
    locate<kPaged>(a.pages, b, t0 + j, outer, row);
    cp_async16(k_dst + j * dh + o,
               a.k + outer * a.kl.s0 + row * a.kl.s1 + h * a.kl.sh + o);
    cp_async16(v_dst + j * dh + o,
               a.v + outer * a.vl.s0 + row * a.vl.s1 + h * a.vl.sh + o);
  }
  if constexpr (kQuant<KT>) {
    for (int j = threadIdx.x; j < nk; j += kThreads) {
      int outer, row;
      locate<kPaged>(a.pages, b, t0 + j, outer, row);
      cp_async4(ks_dst + j,
                a.ks + outer * a.ksl.s0 + row * a.ksl.s1 + h * a.ksl.sh);
      cp_async4(vs_dst + j,
                a.vs + outer * a.vsl.s0 + row * a.vsl.s1 + h * a.vsl.sh);
    }
  }
}

// Shared memory: two stages of K and V tiles (cache type), for int8 their
// two stages of K and V scales, then f32 q rows, scores, second-half partial
// dots and the (m, l, corr) rows.
__host__ __device__ constexpr size_t smem_bytes(int dh, int kv_elt,
                                                bool quant) {
  return 4ull * kTileKeys * dh * kv_elt +
         (quant ? sizeof(float) * 4 * kTileKeys : 0) +
         sizeof(float) * (kMaxGroup * dh + 2 * kMaxGroup * kTileKeys +
                          3 * kMaxGroup);
}

// QT: type of q and of the output; KT: type of the cache.
template <typename QT, typename KT, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Args<KT> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = a.dh, g = a.g;
  const int tile = kTileKeys * dh;
  KT* stage = reinterpret_cast<KT*>(smem);     // [2][K, V][kTileKeys][dh]
  float* sc = reinterpret_cast<float*>(stage + 4 * tile);  // [2][K, V][keys]
  float* q_s = sc + (kQuant<KT> ? 4 * kTileKeys : 0);       // [g][dh]
  float* s_p = q_s + kMaxGroup * dh;           // [g][kTileKeys]
  float* part = s_p + kMaxGroup * kTileKeys;   // [g][kTileKeys]
  float* s_m = part + kMaxGroup * kTileKeys;
  float* s_l = s_m + kMaxGroup;
  float* s_corr = s_l + kMaxGroup;

  const int b = blockIdx.x / a.hkv;
  const int h = blockIdx.x % a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(a.lengths[b], 0), a.rows);
  const int ntiles = (len + kTileKeys - 1) / kTileKeys;

  const QT* qb = static_cast<const QT*>(a.q) + b * a.q_sb +
                 static_cast<long long>(h) * g * a.q_sh;

  if (ntiles > 0)
    load_tile<kPaged>(stage, stage + tile, sc, sc + kTileKeys, a, b, h, 0,
                      min(kTileKeys, len));
  cp_async_commit();

  for (int i = tid; i < g * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const float x = to_float(qb[r * a.q_sh + d]);
    if constexpr (kQuant<KT>)
      q_s[i] = x;   // the int8 kernel keeps q in f32
    else            // q rounded to the cache type, as the TPU kernel feeds
      q_s[i] = to_float(from_float<KT>(x));   // it to the MXU in it
  }
  if (tid < kMaxGroup) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  float acc[kMaxGroup];  // column tid of every q row
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) acc[r] = 0.f;

  const int hd = dh / 2;          // each key's dot is split in two halves
  const int j_own = tid % kTileKeys;
  const int half = tid / kTileKeys;

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * kTileKeys;
    const int nk = min(kTileKeys, len - t0);
    if (t + 1 < ntiles) {
      const int nxt = 2 * ((t + 1) & 1);
      KT* next = stage + nxt * tile;
      load_tile<kPaged>(next, next + tile, sc + nxt * kTileKeys,
                        sc + (nxt + 1) * kTileKeys, a, b, h, t0 + kTileKeys,
                        min(kTileKeys, len - t0 - kTileKeys));
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this thread's copies of tile t landed
    __syncthreads();              // ... and every thread's
    const KT* ks = stage + 2 * (t & 1) * tile;
    const KT* vs = ks + tile;
    const float* k_sc = sc + 2 * (t & 1) * kTileKeys;
    const float* v_sc = k_sc + kTileKeys;

    // 1. Scores.  Thread (j_own, half) dots key j_own with q over one half
    // of dh, four columns per load, starting at a chunk that differs per
    // lane so the lanes of a warp hit distinct shared-memory banks.
    float dot[kMaxGroup];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) dot[r] = 0.f;
    if (j_own < nk) {
      const KT* krow = ks + j_own * dh + half * hd;
      const float kscale = kQuant<KT> ? k_sc[j_own] : 1.f;
      const float* qcol = q_s + half * hd;
      const int chunks = hd / 4;
      int c = j_own % chunks;
      for (int i = 0; i < chunks; ++i) {
        const float4 k4 = load4(krow + 4 * c, kscale);
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g) dot[r] = dot4(load4(qcol + r * dh + 4 * c, 1.f), k4,
                                   dot[r]);
        if (++c == chunks) c = 0;
      }
    }
    if (half == 1 && j_own < nk) {
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r)
        if (r < g) part[r * kTileKeys + j_own] = dot[r];
    }
    __syncthreads();
    if (half == 0 && j_own < nk) {
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r)
        if (r < g)
          s_p[r * kTileKeys + j_own] =
              (dot[r] + part[r * kTileKeys + j_own]) * a.scale;
    }
    __syncthreads();

    // 2. Online softmax.  Warp w updates rows w, w + 4, ...
    for (int r = warp; r < g; r += kThreads / 32) {
      float* row = s_p + r * kTileKeys;
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p @ V; thread tid owns column tid and takes
    // four keys' probabilities per load.
    if (tid < dh) {
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r)
        if (r < g) acc[r] *= s_corr[r];
      int j = 0;
      for (; j + 4 <= nk; j += 4) {
        const float4 v4 = make_float4(
            deq(vs[j * dh + tid], kQuant<KT> ? v_sc[j] : 1.f),
            deq(vs[(j + 1) * dh + tid], kQuant<KT> ? v_sc[j + 1] : 1.f),
            deq(vs[(j + 2) * dh + tid], kQuant<KT> ? v_sc[j + 2] : 1.f),
            deq(vs[(j + 3) * dh + tid], kQuant<KT> ? v_sc[j + 3] : 1.f));
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g)
            acc[r] = dot4(load4(s_p + r * kTileKeys + j, 1.f), v4, acc[r]);
      }
      for (; j < nk; ++j) {
        const float vv = deq(vs[j * dh + tid], kQuant<KT> ? v_sc[j] : 1.f);
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g) acc[r] = fmaf(s_p[r * kTileKeys + j], vv, acc[r]);
      }
    }
    __syncthreads();  // the stage is free for tile t + 2
  }

  if (tid < dh) {
    QT* ob = static_cast<QT*>(a.out) +
             (static_cast<long long>(b) * a.hkv + h) * g * dh;
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      if (r < g) {
        const float o = len > 0 ? acc[r] / fmaxf(s_l[r], 1e-30f) : 0.f;
        ob[r * dh + tid] = from_float<QT>(o);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Lets the kernel take the shared memory of the largest dh.  The attribute
// belongs to the current device and never changes, so it is set once per
// instantiation and device instead of on every launch of a decode step.
template <typename QT, typename KT, bool kPaged>
cudaError_t allow_max_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      decode_kernel<QT, KT, kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxDh, sizeof(KT), kQuant<KT>)));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// The arguments every layout shares; an entry adds scales and pages.
template <typename KT>
Args<KT> make_args(const void* q, void* out, const void* k, const void* v,
                   const void* lengths, int hkv, int g, int dh, int rows,
                   long long q_sb, long long q_sh, Layout kl, Layout vl,
                   float scale) {
  Args<KT> a{};
  a.q = q;
  a.out = out;
  a.k = static_cast<const KT*>(k);
  a.v = static_cast<const KT*>(v);
  a.kl = kl;
  a.vl = vl;
  a.lengths = static_cast<const int*>(lengths);
  a.hkv = hkv;
  a.g = g;
  a.dh = dh;
  a.rows = rows;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.scale = scale;
  return a;
}

// Checks the limits every entry shares; 0 if the launch may go ahead.
inline int check_shape(int batch, int hkv, int g, int dh, int kv_elt) {
  if (g < 1 || g > kMaxGroup || dh < 8 || dh > kMaxDh || dh % 8 ||
      (dh * kv_elt) % 16 || batch < 0 || hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename QT, typename KT, bool kPaged>
int launch(const Args<KT>& a, int batch, cudaStream_t stream) {
  if (batch == 0) return 0;
  const cudaError_t err = allow_max_smem<QT, KT, kPaged>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(a.dh, sizeof(KT), kQuant<KT>);
  decode_kernel<QT, KT, kPaged>
      <<<batch * a.hkv, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
