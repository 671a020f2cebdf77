// Fused single-query GQA decode attention over a contiguous KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/decode.py ::
// decode_attention (body _decode_kernel, GQA wrapper gqa_decode_attention):
// one new token per sequence attends over its own valid cache prefix.
//
// Work: for every (sequence b, KV head h) the g = Hq/Hkv query rows of that
// head read the same K and V rows, so one block owns one (b, h) and streams
// each of its K/V rows once for the whole group -- the cache is never
// repeated per query head.  The block stops at min(length[b], L): no key
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
// The cache is read in its (B, L, Hkv, dh) layout through strides, so the
// caller never copies it into a (B*Hkv, L, dh) fold.  Known gap: B*Hkv
// blocks (32 at batch 4) leave most of the 132 SMs idle; splitting the keys
// of a row across blocks with a combine pass (flash-decoding) is the fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;      // keys per tile; two threads per key
constexpr int kMaxGroup = 16;      // query rows per KV head
constexpr int kMaxDh = 128;        // one thread per output column
constexpr float kNegInf = -1e30f;

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

// Four consecutive cache elements as f32: one 16-byte (f32) or 8-byte
// (bf16) shared-memory load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy keys [t0, t0 + nk) of one (b, h) row of K and V into a stage.
template <typename KT>
__device__ __forceinline__ void load_tile(KT* ks, KT* vs, const KT* kb,
                                          const KT* vb, long long k_sl,
                                          long long v_sl, int t0, int nk,
                                          int dh) {
  constexpr int kPerChunk = 16 / sizeof(KT);
  const int chunks = dh / kPerChunk;
  for (int c = threadIdx.x; c < nk * chunks; c += kThreads) {
    const int j = c / chunks;
    const int o = (c - j * chunks) * kPerChunk;
    cp_async16(ks + j * dh + o, kb + (t0 + j) * k_sl + o);
    cp_async16(vs + j * dh + o, vb + (t0 + j) * v_sl + o);
  }
}

// Shared memory: two stages of K and V tiles (cache dtype), then f32 q rows,
// scores, second-half partial dots and the (m, l, corr) rows.
__host__ __device__ constexpr size_t smem_bytes(int dh, int kv_elt) {
  return 4ull * kTileKeys * dh * kv_elt +
         sizeof(float) * (kMaxGroup * dh + 2 * kMaxGroup * kTileKeys +
                          3 * kMaxGroup);
}

// QT: type of q and of the output; KT: type of the cache.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const int* __restrict__ lengths,
    QT* __restrict__ out, int hkv, int g, int dh, int cache_len,
    long long q_sb, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = kTileKeys * dh;
  KT* stage = reinterpret_cast<KT*>(smem);     // [2][K, V][kTileKeys][dh]
  float* q_s = reinterpret_cast<float*>(stage + 4 * tile);  // [g][dh]
  float* s_p = q_s + kMaxGroup * dh;           // [g][kTileKeys]
  float* part = s_p + kMaxGroup * kTileKeys;   // [g][kTileKeys]
  float* s_m = part + kMaxGroup * kTileKeys;
  float* s_l = s_m + kMaxGroup;
  float* s_corr = s_l + kMaxGroup;

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), cache_len);
  const int ntiles = (len + kTileKeys - 1) / kTileKeys;

  const QT* qb = q + b * q_sb + static_cast<long long>(h) * g * q_sh;
  const KT* kb = k + b * k_sb + h * k_sh;
  const KT* vb = v + b * v_sb + h * v_sh;

  if (ntiles > 0)
    load_tile(stage, stage + tile, kb, vb, k_sl, v_sl, 0,
              min(kTileKeys, len), dh);
  cp_async_commit();

  // q rounded to the cache dtype first, as the TPU kernel feeds it to the
  // MXU in it.
  for (int i = tid; i < g * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[i] = to_float(from_float<KT>(to_float(qb[r * q_sh + d])));
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
      KT* next = stage + 2 * ((t + 1) & 1) * tile;
      load_tile(next, next + tile, kb, vb, k_sl, v_sl, t0 + kTileKeys,
                min(kTileKeys, len - t0 - kTileKeys), dh);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this thread's copies of tile t landed
    __syncthreads();              // ... and every thread's
    const KT* ks = stage + 2 * (t & 1) * tile;
    const KT* vs = ks + tile;

    // 1. Scores.  Thread (j_own, half) dots key j_own with q over one half
    // of dh, four columns per load, starting at a chunk that differs per
    // lane so the lanes of a warp hit distinct shared-memory banks.
    float dot[kMaxGroup];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) dot[r] = 0.f;
    if (j_own < nk) {
      const KT* krow = ks + j_own * dh + half * hd;
      const float* qcol = q_s + half * hd;
      const int chunks = hd / 4;
      int c = j_own % chunks;
      for (int i = 0; i < chunks; ++i) {
        const float4 k4 = load4(krow + 4 * c);
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g) dot[r] = dot4(load4(qcol + r * dh + 4 * c), k4, dot[r]);
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
              (dot[r] + part[r * kTileKeys + j_own]) * scale;
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
        const float4 v4 = make_float4(to_float(vs[j * dh + tid]),
                                      to_float(vs[(j + 1) * dh + tid]),
                                      to_float(vs[(j + 2) * dh + tid]),
                                      to_float(vs[(j + 3) * dh + tid]));
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g) acc[r] = dot4(load4(s_p + r * kTileKeys + j), v4, acc[r]);
      }
      for (; j < nk; ++j) {
        const float vv = to_float(vs[j * dh + tid]);
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g) acc[r] = fmaf(s_p[r * kTileKeys + j], vv, acc[r]);
      }
    }
    __syncthreads();  // the stage is free for tile t + 2
  }

  if (tid < dh) {
    QT* ob = out + (static_cast<long long>(b) * hkv + h) * g * dh;
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
template <typename QT, typename KT>
cudaError_t allow_max_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      decode_attention_kernel<QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxDh, sizeof(KT))));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int batch, int hkv, int g, int dh, int cache_len,
           long long q_sb, long long q_sh, long long k_sb, long long k_sl,
           long long k_sh, long long v_sb, long long v_sl, long long v_sh,
           float scale, cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<QT, KT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(dh, sizeof(KT));
  decode_attention_kernel<QT, KT><<<batch * hkv, kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(lengths),
      static_cast<QT*>(out), hkv, g, dh, cache_len, q_sb, q_sh, k_sb, k_sl,
      k_sh, v_sb, v_sl, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes.  q: (B, Hq, dh) with strides (q_sb, q_sh, 1);
// k, v: (B, L, Hkv, dh) with strides (sb, sl, sh, 1), 16-byte aligned rows;
// lengths: (B,) int32; out: contiguous (B, Hq, dh) of q's type.  q_bf16 /
// kv_bf16 select bfloat16 (1) or float32 (0).  Returns the CUDA error of
// the launch (0 on success).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int q_bf16, int kv_bf16, int batch, int hkv, int g, int dh,
    int cache_len, long long q_sb, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, float scale, void* stream) {
  const int kv_elt = kv_bf16 ? 2 : 4;
  if (g < 1 || g > kMaxGroup || dh < 8 || dh > kMaxDh || dh % 8 ||
      (dh * kv_elt) % 16 || batch < 0 || hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, batch, hkv, g, dh, cache_len, q_sb, q_sh,
        k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(
        q, k, v, lengths, out, batch, hkv, g, dh, cache_len, q_sb, q_sh,
        k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(
        q, k, v, lengths, out, batch, hkv, g, dh, cache_len, q_sb, q_sh,
        k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, s);
  return launch<float, float>(q, k, v, lengths, out, batch, hkv, g, dh,
                              cache_len, q_sb, q_sh, k_sb, k_sl, k_sh, v_sb,
                              v_sl, v_sh, scale, s);
}
