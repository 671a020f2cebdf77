// Forward flash attention for prefill, with mask-driven block skipping.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/kernel.py ::
// flash_attention (body _flash_kernel; public wrapper ops.py ::
// mha_attention).  Query row i of head h attends to key j of KV head
// h / g (g = Hq / Hkv) when i >= j (causal), i - j < window (sliding
// window) and j < Sk; positions count from 0 in each sequence.  A row with
// no surviving key writes exact zeros.
//
// Work: one block owns one tile of query rows of one (sequence, query
// head) and walks the key tiles of its band, [first, last] of
// core/cost_model.py :: attention_step_bounds, mirrored in step_bounds
// below at the block's tile.  Tiles outside the band are neither loaded
// nor multiplied, so causal prefill walks the triangle and a 4096-key
// window a band of about 4096 / tile tiles; only tiles that cross the
// diagonal, the window's edge or the ragged Sk tail are masked.  GQA is
// index math: the block of query head h reads KV head h / g in place
// through the strides, so K and V are never repeated in memory (the TPU
// wrapper repeats them g times, along the batch axis).  Causal blocks
// start with the longest rows, so the last wave of blocks is the
// shortest.  Online softmax in f32 in the log2 domain: a running max and
// sum per row, the unnormalised probabilities rounded to bf16 for the p.v
// product as the TPU kernel rounds them to v's dtype, and a store that
// divides by max(l, 1e-30).
//
// Bound: tensor-core operations.  Each (q, k) pair of a head costs 4 * dh
// operations (q.k and p.v); a 128 x 128 tile does 128 multiply-adds per
// element it loads, far above the H100's ~295 bf16 operations per byte of
// device memory.  Three designs, picked by the wrapper from (dtype,
// head_dim) (kernels/attention/kernel.py :: design):
//
// wgmma (bf16 at head_dim 128, Qwen3-14B's prefill; flash_wgmma_kernel):
// FlashAttention-3's layout.  A block of three warpgroups owns 128 query
// rows.  The producer warpgroup gives up registers (setmaxnreg) and one
// of its threads issues TMA copies: q once, then K and V tiles of 128
// keys into a ring of two stages, each copy completing on an mbarrier;
// a K (V) stage is refilled when both consumers have arrived on its
// "empty" barrier.  Each of the two consumer warpgroups (setmaxnreg up to
// 240) owns 64 rows: s = q k^T on wgmma m64n128k16 with both operands in
// shared memory (K-major), the softmax in f32 registers, then o += p v on
// wgmma with p as register A fragments (the f32 score layout is the bf16
// A-fragment layout, pairs of columns packed) and V as an MN-major B
// operand (head_dim contiguous, the transpose bit).  A consumer issues
// tile j's q k^T together with tile j - 1's p v, frees K's stage as soon
// as its q k^T is done, and runs tile j's softmax while p v is on the
// tensor cores.  Tiles are 128 rows of 128 head dims, two 64-column boxes
// in TMA's 128-byte swizzle, which the wgmma descriptors (leading byte
// offset: the second box, stride byte offset: 8 rows of 128 bytes) read
// as laid.  TMA fills rows past Sq or Sk with zeros; the mask, not the
// zeros, removes such keys.  Shared memory: q 32 KB + 2 x (K, V) 64 KB =
// 160 KB.  Tensor maps are built on the host per call from the strides,
// through the driver entry point the runtime hands out (no link against
// libcuda).  A ping-pong between the two consumers (turns on named
// barriers) measured no faster, and is left out.
//
// mma.sync (bf16 at head_dim 16, 80, 96; flash_bf16_kernel): one block
// of 4 warps owns 64 query rows and walks 64-key tiles; each warp owns
// 16 rows, keeps its q fragments, scores, probabilities and output in
// registers and reads K and V from shared memory with ldmatrix (mma.sync
// m16n8k16, f32 accumulators).  The next K/V tile is copied with cp.async
// while the current one is computed (two stages); rows are padded by 16
// bytes so ldmatrix reads are free of bank conflicts.  head_dim 80 would
// need 160-byte TMA boxes, past the 128-byte swizzle.
//
// f32 (not on the prefill path; for f32 callers and tests;
// flash_f32_kernel): the same 64 x 64 walk with f32 FMAs on CUDA cores,
// two threads per query row.

#include <cuda.h>
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
  float scale;
};

// [first, last] K tiles of query tile i at tile (BQ, BK):
// attention_step_bounds.
template <int BQ, int BK>
__device__ __forceinline__ void step_bounds(const Params& p, int i,
                                            int& first, int& last) {
  const int q_lo = i * BQ, q_hi = q_lo + BQ - 1;
  last = (p.sk + BK - 1) / BK - 1;
  if (p.causal) last = min(last, q_hi / BK);
  first = 0;
  if (p.window > 0) {
    const int n = q_lo - p.window + 1;   // floor division, as in Python
    first = max(0, n >= 0 ? n / BK : -((-n + BK - 1) / BK));
  }
  first = min(first, last);
}

// Whether any pair of the (BQ query rows at q0, BK keys at k0) tile is
// masked.
template <int BQ, int BK>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int k0) {
  if (k0 + BK > p.sk) return true;
  if (p.causal && k0 + BK - 1 > q0) return true;
  return p.window > 0 && (q0 + BQ - 1) - k0 >= p.window;
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
  step_bounds<kBlockQ, kBlockK>(p, tile, first, last);

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
    const bool masked = tile_needs_mask<kBlockQ, kBlockK>(p, q0, k0);
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
  step_bounds<kBlockQ, kBlockK>(p, tile, first, last);

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
// bf16 at head_dim 128 on Hopper: TMA, wgmma, warp specialisation
// --------------------------------------------------------------------------

namespace hopper {

constexpr int kM = 128;            // query rows per block: 2 consumers x 64
constexpr int kN = 128;            // keys per tile
constexpr int kD = 128;            // head_dim
constexpr int kBox = 64;           // columns of one TMA box: 128 bytes
constexpr int kStages = 2;         // K/V ring
constexpr int kThreads = 384;      // consumers 0 and 1, producer 2
constexpr int kBoxBytes = kN * kBox * 2;   // 16 KB: 128 rows x 64 columns
constexpr int kTileBytes = 2 * kBoxBytes;  // 32 KB: 128 rows x 128 columns

// Each tile is two boxes, columns [0, 64) and [64, 128), each 128 rows of
// 128 bytes in TMA's 128-byte swizzle; every box starts on 1024 bytes.
struct Smem {
  bf16 q[2][kM * kBox];
  bf16 k[kStages][2][kN * kBox];
  bf16 v[kStages][2][kN * kBox];
  unsigned long long q_full;
  unsigned long long k_full[kStages];
  unsigned long long v_full[kStages];
  unsigned long long k_empty[kStages];   // both consumers done with K (s)
  unsigned long long v_empty[kStages];   // ... with V (s)
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + alignment slack

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

// One box of a 4-D (dh, heads, seq, batch) tensor map into shared memory,
// completing on ``bar``; rows past the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         unsigned long long* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at ``p``:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128-byte swizzle).
__device__ __forceinline__ unsigned long long desc(const void* p,
                                                   unsigned lbo,
                                                   unsigned sbo) {
  return static_cast<unsigned long long>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32) | (1ull << 62);
}

// Pins the order of register reads and writes against the asynchronous
// wgmma statements around it (the compiler sees their operands as
// written at issue, the card at wait).
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
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

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) + (scale_d ? d : 0); a and
// b K-major in shared memory (q rows and k rows, head_dim contiguous).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], int scale_d,
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
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 128, f32) += a (64 x 16, bf16 fragments in registers) b (16 x
// 128); b MN-major in shared memory (v rows, head_dim contiguous: the
// transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const unsigned (&a)[4],
                                         unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// s = q k^T for consumer wg's 64 rows against the K tile in stage st: 8
// steps of 16 head dims, 4 in each box, the first overwriting s.  Issued
// and committed as one group, not awaited.
__device__ __forceinline__ void issue_qk(float (&sc)[64], Smem& sm, int wg,
                                         int st) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 16;
    wgmma_ss(sc, kk > 0, desc(sm.q[box] + wg * 64 * kBox + off, 16, 1024),
             desc(sm.k[st][box] + off, 16, 1024));
  }
  wgmma_commit();
  fence_regs(sc);
}

// o += p v against the V tile in stage st: 8 steps of 16 keys, V MN-major
// with its two head-dim boxes 16 KB apart (leading byte offset).  Issued
// and committed, not awaited; p's registers stay live until the wait.
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         unsigned (&pa)[kN / 16][4],
                                         Smem& sm, int st) {
#pragma unroll
  for (int j = 0; j < kN / 16; ++j) fence_regs(pa[j]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kN / 16; ++j)
    wgmma_rs(o, pa[j], desc(sm.v[st][0] + j * 16 * kBox, kBoxBytes, 1024));
  wgmma_commit();
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < kN / 16; ++j) fence_regs(pa[j]);
}

// Online softmax of one key tile at k0 for rows row_a (d[4 i + e], e < 2)
// and row_b: scales and masks the scores, moves the running max m,
// rescales the running sum l by corr = exp2(m_old - m_new) and adds the
// tile's probabilities, which replace the scores in sc (f32).  A row's
// 128 scores live in the 4 lanes of its quad, 32 each.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Params& p, bool masked,
                                             int row_a, int row_b, int k0,
                                             int tq4) {
  const float sl2 = p.scale * kLog2e;   // scores in the log2 domain
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = sc[i] * sl2;
    if (masked && !pair_ok(p, (i & 2) ? row_b : row_a,
                           k0 + (i >> 2) * 8 + 2 * tq4 + (i & 1)))
      x = kNegInf;
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
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
  for (int i = 0; i < 64; i += 2) {
    const int r = (i >> 1) & 1;
    // a row with no surviving key yet stays at m = -1e30: its
    // probabilities are 0, not exp2(0) = 1
    const float p0 = m[r] <= kNegInf ? 0.f : exp2f(sc[i] - m[r]);
    const float p1 = m[r] <= kNegInf ? 0.f : exp2f(sc[i + 1] - m[r]);
    l[r] += p0 + p1;   // pairs first: half the chain of dependent adds
    sc[i] = p0;
    sc[i + 1] = p1;
  }
}

// p rounded to bf16 into the register A fragments of o += p v: keys
// [16 j, 16 j + 16) are score columns 16 j .. 16 j + 15, so a[0..3] =
// pack(d[8 j + 0, 1]), pack(d[8 j + 2, 3]), pack(d[8 j + 4, 5]),
// pack(d[8 j + 6, 7]).
__device__ __forceinline__ void pack_p(unsigned (&pa)[kN / 16][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2)
    pa[i >> 3][(i >> 1) & 3] = pack_bf16(sc[i], sc[i + 1]);
}

// Fragment layouts (PTX ISA, wgmma .m64nNk16): warp w of a consumer owns
// rows 16 w + gr and 16 w + gr + 8 of its 64 (lane = 4 gr + tq); score and
// output accumulators: d[4 i + e] is column 8 i + 2 tq + (e & 1) of row
// gr (e < 2) or gr + 8.
//
// A consumer's tile j: it issues s_j = q k_j^T and o += p_{j-1} v_{j-1}
// together, waits for s_j only, runs tile j's softmax in f32 while the
// tensor cores finish p_{j-1} v_{j-1}, then rescales o and packs p_j.
// p_j is packed only after p_{j-1} v_{j-1} has retired: a second register
// set for p, written during the product, made ptxas serialise the wgmma.
// Rows past Sq are computed on TMA's zeros and never stored.
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.g;
  const int q0 = tile * kM;
  int first, last;
  step_bounds<kM, kN>(p, tile, first, last);
  const int n_tiles = last - first + 1;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 2 * 128);   // every consumer thread
      mbar_init(&sm.v_empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
      tma_load(sm.q[0], &tq, &sm.q_full, 0, h, q0, b);
      tma_load(sm.q[1], &tq, &sm.q_full, kBox, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, row = (first + it) * kN;
        const unsigned free = ((it / kStages) & 1) ^ 1;   // use 0: at once
        mbar_wait(&sm.k_empty[s], free);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load(sm.k[s][0], &tk, &sm.k_full[s], 0, hk, row, b);
        tma_load(sm.k[s][1], &tk, &sm.k_full[s], kBox, hk, row, b);
        mbar_wait(&sm.v_empty[s], free);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load(sm.v[s][0], &tv, &sm.v_full[s], 0, hk, row, b);
        tma_load(sm.v[s][1], &tv, &sm.v_full[s], kBox, hk, row, b);
      }
    }
  } else {
    // ---- consumer wg: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31;
    const int gr = lane >> 2, tq4 = lane & 3;
    const int row_a = q0 + wg * 64 + warp * 16 + gr, row_b = row_a + 8;
    float m[2] = {kNegInf, kNegInf};      // running max (log2 domain)
    float l[2] = {0.f, 0.f};              // this thread's share of the sum
    float corr[2];
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    unsigned pa[kN / 16][4];              // p of the previous tile

    mbar_wait(&sm.q_full, 0);
    {
      // Tile 0: s = q k^T and its softmax (o is still 0).
      float sc[64];
      mbar_wait(&sm.k_full[0], 0);
      issue_qk(sc, sm, wg, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&sm.k_empty[0]);
      const int k0 = first * kN;
      softmax_tile(sc, m, l, corr, p, tile_needs_mask<kM, kN>(p, q0, k0),
                   row_a, row_b, k0, tq4);
      pack_p(pa, sc);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % kStages, ps = (it - 1) % kStages;
      float sc[64];
      mbar_wait(&sm.k_full[s], (it / kStages) & 1);
      mbar_wait(&sm.v_full[ps], ((it - 1) / kStages) & 1);
      issue_qk(sc, sm, wg, s);
      issue_pv(o, pa, sm, ps);
      wgmma_wait<1>();                   // s of tile it is in
      fence_regs(sc);
      mbar_arrive(&sm.k_empty[s]);
      const int k0 = (first + it) * kN;
      softmax_tile(sc, m, l, corr, p, tile_needs_mask<kM, kN>(p, q0, k0),
                   row_a, row_b, k0, tq4);
      wgmma_wait<0>();                   // o += p v of tile it - 1 is in
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < kN / 16; ++j) fence_regs(pa[j]);
      mbar_arrive(&sm.v_empty[ps]);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p(pa, sc);
    }
    {
      // The last tile's o += p v.
      const int s = (n_tiles - 1) % kStages;
      mbar_wait(&sm.v_full[s], ((n_tiles - 1) / kStages) & 1);
      issue_pv(o, pa, sm, s);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // Store o / max(l, 1e-30); rows past Sq are padding.
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
                            kD;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * tq4) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] * l[r],
                                  o[4 * i + 2 * r + 1] * l[r]);
    }
  }
}

}  // namespace hopper

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
    if constexpr (DH == hopper::kD) {
      return static_cast<int>(cudaErrorInvalidValue);   // the wgmma entry's
    } else {
      static std::atomic<bool> done[kMaxDevices];
      err = allow_smem(flash_bf16_kernel<DH>, bf16_smem<DH>(), done);
      if (err != cudaSuccess) return static_cast<int>(err);
      flash_bf16_kernel<DH><<<grid, kThreads, bf16_smem<DH>(), stream>>>(p);
    }
  } else {
    static std::atomic<bool> done[kMaxDevices];
    err = allow_smem(flash_f32_kernel<DH>, f32_smem<DH>(), done);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_kernel<DH><<<grid, kThreads, f32_smem<DH>(), stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

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

// A (dh, heads, seq, batch) bf16 operand read in boxes of 64 head dims x
// 1 head x 128 rows x 1 sequence, 128-byte swizzle; strides in elements.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                int heads, int seq, int batch, long long s_h, long long s_s,
                long long s_b) {
  const cuuint64_t dims[4] = {hopper::kD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {hopper::kBox, 1, hopper::kN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const Params& p, int batch, int hkv, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, p.q, p.hq, p.sq, batch, p.q_sh, p.q_ss,
                  p.q_sb) ||
      !tensor_map(&tk, encode, p.k, hkv, p.sk, batch, p.k_sh, p.k_ss,
                  p.k_sb) ||
      !tensor_map(&tv, encode, p.v, hkv, p.sk, batch, p.v_sh, p.v_ss,
                  p.v_sb))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err =
      allow_smem(hopper::flash_wgmma_kernel, hopper::kSmemBytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + hopper::kM - 1) / hopper::kM, p.hq, batch);
  hopper::flash_wgmma_kernel<<<grid, hopper::kThreads, hopper::kSmemBytes,
                               stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes.  q: (B, Sq, Hq, dh) with strides (q_sb,
// q_ss, q_sh, 1); k, v: (B, Sk, Hkv, dh) with strides (.., 1); every
// stride but the last and every address a multiple of 16 bytes.  out:
// contiguous (B, Sq, Hq, dh) of q's type.  window 0 means no window.
// Return the CUDA error of the launch (0 on success).
#define FLASH_ARGS                                                          \
  const void *q, const void *k, const void *v, void *out, int is_bf16,     \
      int batch, int sq, int sk, int hq, int hkv, int dh, int causal,       \
      int window, long long q_sb, long long q_ss, long long q_sh,           \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,       \
      long long v_ss, long long v_sh, float scale, void *stream

namespace {

bool make_params(Params& p, FLASH_ARGS) {
  if (batch < 1 || sq < 1 || sk < 1 || hkv < 1 || hq < 1 || hq % hkv ||
      window < 0 || hq > 65535 || batch > 65535)
    return false;
  p = Params{};
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
  p.scale = scale;
  (void)is_bf16;
  (void)stream;
  return true;
}

}  // namespace

#define FLASH_NAMES                                                       \
  q, k, v, out, is_bf16, batch, sq, sk, hq, hkv, dh, causal, window, q_sb, \
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, stream

// mma.sync (bf16, is_bf16 1) at head_dim 16, 80 and 96, CUDA cores (f32,
// is_bf16 0) at 16, 80, 96 and 128.
extern "C" int flash_attention(FLASH_ARGS) {
  Params p;
  if (!make_params(p, FLASH_NAMES))
    return static_cast<int>(cudaErrorInvalidValue);
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

// TMA and wgmma: bf16 (is_bf16 1) at head_dim 128 only.
extern "C" int flash_attention_wgmma(FLASH_ARGS) {
  Params p;
  if (!make_params(p, FLASH_NAMES) || is_bf16 != 1 || dh != hopper::kD)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma(p, batch, hkv, static_cast<cudaStream_t>(stream));
}
