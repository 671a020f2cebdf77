// Forward flash attention for prefill, with mask-driven block skipping.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/kernel.py ::
// flash_attention (body _flash_kernel; public wrapper ops.py ::
// mha_attention).  Query row i of head h attends to key j of KV head
// h / g (g = Hq / Hkv) when i >= j (causal), i - j < window (sliding
// window) and j < Sk; positions count from 0 in each sequence.  A row with
// no surviving key writes exact zeros.
//
// Work: one block owns one tile of 64 query rows of one (sequence, query
// head) and walks the 64-key tiles of its band, [first, last] of
// core/cost_model.py :: attention_step_bounds, mirrored in step_bounds
// below.  Tiles outside the band are neither loaded nor multiplied, so
// causal prefill walks the triangle and a 4096-key window a band of about
// 4096 / 64 tiles.  GQA is index math: the block of query head h reads
// KV head h / g in place through the strides, so K and V are never
// repeated in memory (the TPU wrapper repeats them g times, along the
// batch axis).  Causal blocks start with the longest rows, so the last
// wave of blocks is the shortest.
//
// Bound: tensor-core operations.  Each (q, k) pair of a head costs 4 * dh
// operations (q.k and p.v); a 64 x 64 tile does 64 multiply-adds per
// element it loads, far above the H100's ~295 bf16 operations per byte
// of device memory.  The bf16 kernel therefore runs both products on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators):
// each of the 4 warps owns 16 query rows, keeps its q fragments, scores,
// probabilities and output accumulator in registers, and reads K and V
// tiles from shared memory with ldmatrix.  The next K/V tile is copied
// with cp.async while the current one is computed (two stages); rows are
// padded by 16 bytes so ldmatrix reads are free of bank conflicts.
// Online softmax in f32: a running max and sum per row, the unnormalised
// probabilities rounded to bf16 for the p.v product as the TPU kernel
// rounds them to v's dtype, and a store that divides by max(l, 1e-30).
// Known gap: mma.sync reaches a fraction of the card's wgmma rate, and
// the tile is small (ROADMAP queue D4).
//
// The f32 kernel (not on the prefill path; for f32 callers and tests) does
// the same walk with f32 FMAs on CUDA cores: two threads per query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlockQ = 64;       // query rows per block
constexpr int kBlockK = 64;       // keys per tile
constexpr int kThreads = 128;     // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                        // contiguous (B, Sq, Hq, dh)
  long long q_sb, q_ss, q_sh;     // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int sq, sk, hq, g, dh;
  int causal, window;             // window 0: none
  int k_steps;                    // ceil(Sk / kBlockK)
  float scale;
};

// [first, last] K tiles of query tile i: attention_step_bounds.
__device__ __forceinline__ void step_bounds(const Params& p, int i,
                                            int& first, int& last) {
  const int q_lo = i * kBlockQ, q_hi = q_lo + kBlockQ - 1;
  last = p.k_steps - 1;
  if (p.causal) last = min(last, q_hi / kBlockK);
  first = 0;
  if (p.window > 0) {
    const int n = q_lo - p.window + 1;   // floor division, as in Python
    first = max(0, n >= 0 ? n / kBlockK : -((-n + kBlockK - 1) / kBlockK));
  }
  first = min(first, last);
}

// Whether any pair of the (query tile at q0, key tile at k0) is masked.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int k0) {
  if (k0 + kBlockK > p.sk) return true;
  if (p.causal && k0 + kBlockK - 1 > q0) return true;
  return p.window > 0 && (q0 + kBlockQ - 1) - k0 >= p.window;
}

__device__ __forceinline__ bool pair_ok(const Params& p, int i, int j) {
  return j < p.sk && (!p.causal || i >= j) &&
         (p.window == 0 || i - j < p.window);
}

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

// Rows [r0, r0 + kRows) of a (.., rows, dh) operand at ``base`` with row
// stride ``rs`` into shared memory at row stride ``ld``; rows at or past
// ``n`` are zero-filled (their values are masked or never stored, and
// zeros keep 0 * v finite).
template <typename T, int DH, int kRows>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* base,
                                          long long rs, int r0, int n) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = DH / kPer;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c - row * kChunks) * kPer;
    const int r = r0 + row;
    const bool ok = r < n;
    cp_async16(dst + row * ld + col, base + (ok ? r : 0) * rs + col,
               ok ? 16 : 0);
  }
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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A shared-memory row of bf16: dh padded by 8 elements (16 bytes).
template <int DH>
__host__ __device__ constexpr int bf16_ld() { return DH + 8; }

template <int DH>
__host__ __device__ constexpr size_t bf16_smem() {
  return sizeof(bf16) * bf16_ld<DH>() * (kBlockQ + 4 * kBlockK);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gr + tq.  A rows
// gr and gr + 8, columns 2 tq, 2 tq + 1 (+ 8); B rows (k) 2 tq, 2 tq + 1
// (+ 8), column gr; C rows gr and gr + 8, columns 2 tq, 2 tq + 1.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(const Params p) {
  constexpr int kLd = bf16_ld<DH>();
  constexpr int kDk = DH / 16;       // k-steps of q.k; pairs of p.v n-tiles
  constexpr int kNo = DH / 8;        // n-tiles of the output
  constexpr int kNs = kBlockK / 8;   // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // [kBlockQ][kLd]
  bf16* kv_s = q_s + kBlockQ * kLd;            // [2][K, V][kBlockK][kLd]

  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int q0 = tile * kBlockQ;
  int first, last;
  step_bounds(p, tile, first, last);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<bf16, DH, kBlockQ>(q_s, kLd, qg, p.q_ss, q0, p.sq);
  load_rows<bf16, DH, kBlockK>(kv_s, kLd, kg, p.k_ss, first * kBlockK, p.sk);
  load_rows<bf16, DH, kBlockK>(kv_s + kBlockK * kLd, kLd, vg, p.v_ss,
                               first * kBlockK, p.sk);
  cp_async_commit();

  const float sl2 = p.scale * kLog2e;   // scores in the log2 domain
  const int row_a = q0 + warp * 16 + gr, row_b = row_a + 8;
  float m[2] = {kNegInf, kNegInf};      // running max (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  float o[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  unsigned qf[kDk][4];

  // ldmatrix row addresses: matrix mi = lane / 8, row lane % 8.
  const int mi = lane >> 3, mr = lane & 7;

  for (int kt = first; kt <= last; ++kt) {
    const int it = kt - first;
    if (kt < last) {
      bf16* nxt = kv_s + ((it + 1) & 1) * 2 * kBlockK * kLd;
      load_rows<bf16, DH, kBlockK>(nxt, kLd, kg, p.k_ss, (kt + 1) * kBlockK,
                                   p.sk);
      load_rows<bf16, DH, kBlockK>(nxt + kBlockK * kLd, kLd, vg, p.v_ss,
                                   (kt + 1) * kBlockK, p.sk);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of tile kt (and q) landed
    __syncthreads();      // ... and every thread's
    if (it == 0) {
#pragma unroll
      for (int d = 0; d < kDk; ++d)
        ldmatrix_x4(qf[d], q_s + (warp * 16 + mr + (mi & 1) * 8) * kLd +
                               d * 16 + (mi >> 1) * 8);
    }
    const bf16* ks = kv_s + (it & 1) * 2 * kBlockK * kLd;
    const bf16* vs = ks + kBlockK * kLd;

    // 1. s = q k^T for the warp's 16 rows and the tile's 64 keys.
    float s[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < kDk; ++d) {
#pragma unroll
      for (int np = 0; np < kNs / 2; ++np) {
        unsigned kb[4];
        ldmatrix_x4(kb, ks + (np * 16 + mr + (mi >> 1) * 8) * kLd + d * 16 +
                            (mi & 1) * 8);
        mma16816(s[2 * np], qf[d], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[d], kb[2], kb[3]);
      }
    }

    // 2. Scale, mask, online softmax.  Thread holds rows row_a (e = 0, 1)
    // and row_b (e = 2, 3); a row's 64 scores live in the 4 lanes of its
    // quad.
    const int k0 = kt * kBlockK;
    const bool masked = tile_needs_mask(p, q0, k0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked &&
            !pair_ok(p, e < 2 ? row_a : row_b, k0 + n * 8 + 2 * tq + (e & 1)))
          x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        // a row with no surviving key yet stays at m = -1e30: its
        // probabilities are 0, not exp2(0) = 1
        const float pr = m[r] <= kNegInf ? 0.f : exp2f(s[n][e] - m[r]);
        s[n][e] = pr;
        l[r] += pr;
      }
    }
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // 3. o += p v: p (rounded to bf16) from the score registers as A
    // fragments, v by transposed ldmatrix as B fragments.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDk; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + mr + (mi & 1) * 8) * kLd +
                                  dp * 16 + (mi >> 1) * 8);
        mma16816(o[2 * dp], a, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage is free for tile kt + 2
  }

  // 4. Store o / max(l, 1e-30); rows past Sq are padding.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= p.sq) continue;
    bf16* orow = og + ((static_cast<long long>(b) * p.sq + row) * p.hq + h) *
                          DH;
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[n][2 * r] * l[r], o[n][2 * r + 1] * l[r]);
    }
  }
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------

template <int DH>
__host__ __device__ constexpr int f32_ld() { return DH + 4; }

template <int DH>
__host__ __device__ constexpr size_t f32_smem() {
  return sizeof(float) * (f32_ld<DH>() * (kBlockQ + 2 * kBlockK) +
                          kBlockQ * (kBlockK + 1));
}

// Thread t owns query row t / 2 and half t % 2: scores of keys
// [32 * half, 32 * half + 32) of each tile and output columns
// [DH / 2 * half, DH / 2 * (half + 1)).  One K/V stage.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  constexpr int kLd = f32_ld<DH>();
  constexpr int kHalf = DH / 2;
  constexpr int kKeys = kBlockK / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [kBlockQ][kLd]
  float* k_s = q_s + kBlockQ * kLd;              // [kBlockK][kLd]
  float* v_s = k_s + kBlockK * kLd;
  float* p_s = v_s + kBlockK * kLd;              // [kBlockQ][kBlockK + 1]

  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.g;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int q0 = tile * kBlockQ, row = q0 + r;
  int first, last;
  step_bounds(p, tile, first, last);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows<float, DH, kBlockQ>(q_s, kLd, qg, p.q_ss, q0, p.sq);
  cp_async_commit();

  float m = kNegInf, l = 0.f;
  float acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    load_rows<float, DH, kBlockK>(k_s, kLd, kg, p.k_ss, k0, p.sk);
    load_rows<float, DH, kBlockK>(v_s, kLd, vg, p.v_ss, k0, p.sk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r * kLd + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            k_s + (half * kKeys + j) * kLd + d);
        s[j] = fmaf(qv.w, kv.w,
                    fmaf(qv.z, kv.z,
                         fmaf(qv.y, kv.y, fmaf(qv.x, kv.x, s[j]))));
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float x = s[j] * p.scale;
      if (!pair_ok(p, row, k0 + half * kKeys + j)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float pr = m_new <= kNegInf ? 0.f : expf(s[j] - m_new);
      p_s[r * (kBlockK + 1) + half * kKeys + j] = pr;
      sum += pr;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();   // the partner thread's probabilities of this row
#pragma unroll
    for (int c = 0; c < kHalf; ++c) acc[c] *= corr;
    for (int j = 0; j < kBlockK; ++j) {
      const float pr = p_s[r * (kBlockK + 1) + j];
      const float* vrow = v_s + j * kLd + half * kHalf;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) acc[c] = fmaf(pr, vrow[c], acc[c]);
    }
    __syncthreads();   // k_s, v_s and p_s are free for the next tile
  }

  if (row < p.sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) +
                  ((static_cast<long long>(b) * p.sq + row) * p.hq + h) * DH +
                  half * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) orow[c] = acc[c] * inv;
  }
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

template <int DH>
int launch(const Params& p, int batch, bool is_bf16, cudaStream_t stream) {
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.hq, batch);
  cudaError_t err;
  if (is_bf16) {
    static std::atomic<bool> done[kMaxDevices];
    err = allow_smem(flash_bf16_kernel<DH>, bf16_smem<DH>(), done);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bf16_kernel<DH><<<grid, kThreads, bf16_smem<DH>(), stream>>>(p);
  } else {
    static std::atomic<bool> done[kMaxDevices];
    err = allow_smem(flash_f32_kernel<DH>, f32_smem<DH>(), done);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_kernel<DH><<<grid, kThreads, f32_smem<DH>(), stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes.  q: (B, Sq, Hq, dh) with strides (q_sb, q_ss,
// q_sh, 1); k, v: (B, Sk, Hkv, dh) with strides (.., 1); every stride but
// the last and every address a multiple of 16 bytes.  out: contiguous
// (B, Sq, Hq, dh) of q's type.  is_bf16: all operands bfloat16 (1) or
// float32 (0).  window 0 means no window.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int is_bf16,
    int batch, int sq, int sk, int hq, int hkv, int dh, int causal,
    int window, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || hkv < 1 || hq < 1 || hq % hkv ||
      window < 0 || hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.sq = sq;
  p.sk = sk;
  p.hq = hq;
  p.g = hq / hkv;
  p.dh = dh;
  p.causal = causal != 0;
  p.window = window;
  p.k_steps = (sk + kBlockK - 1) / kBlockK;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b16 = is_bf16 != 0;
  switch (dh) {
    case 16: return launch<16>(p, batch, b16, s);
    case 80: return launch<80>(p, batch, b16, s);
    case 96: return launch<96>(p, batch, b16, s);
    case 128: return launch<128>(p, batch, b16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
