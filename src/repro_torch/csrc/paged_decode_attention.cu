// Fused single-query GQA decode attention through a paged KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/decode.py ::
// paged_gqa_decode_attention (body _paged_decode_kernel): the K and V of
// every sequence live in pages of a pool shared by all sequences, and a
// per-sequence page table names the pool page of each logical page.  Key t
// of sequence b is row t % page_size of pool page pages[b, t / page_size],
// clamped to [0, num_pages).
//
// Bound: device-memory bytes, as for the contiguous kernel: 2 * dh *
// element size per valid key and KV head, plus the page table.  The TPU
// kernel brings the table in by scalar prefetch and its grid walks one page
// per step; here each warp reads the table itself, per key row, as it
// copies the row into its tile.  So the splits, tiles, copies, online
// softmax and in-kernel combine of decode_body.cuh are the contiguous
// kernel's, a tile need not be a whole number of pages, and the split
// bounds depend on key positions alone: a paged cache gives bitwise the
// result of decode_attention.cu over the same rows laid out contiguously,
// whatever the two caches' capacities.

#include "decode_body.cuh"

namespace {

template <typename KT>
int run(const void* q, const void* k, const void* v, const void* pages,
        const void* lengths, void* out, void* part, void* tickets, int q_bf16,
        int batch, int hkv, int g, int dh, int num_pages, int page_size,
        int max_pages, long long q_sb, long long q_sh, Layout kl, Layout vl,
        float scale, cudaStream_t stream) {
  Args<KT> a = make_args<KT>(q, out, q_bf16, k, v, lengths, part, tickets,
                             hkv, g, dh, max_pages * page_size, q_sb, q_sh,
                             kl, vl, scale);
  a.pages = {static_cast<const int*>(pages), max_pages, page_size,
             num_pages};
  return launch<KT, true>(a, batch, stream);
}

}  // namespace

// C entry, bound with ctypes.  q: (B, Hq, dh) with strides (q_sb, q_sh, 1);
// k, v: pools (num_pages, page_size, Hkv, dh) with strides (sp, sl, sh, 1),
// 16-byte aligned rows; pages: contiguous (B, max_pages) int32, -1 = no
// page; lengths: (B,) int32; out: contiguous (B, Hq, dh) of q's type;
// part, part_floats and tickets as for decode_attention, with L =
// max_pages * page_size.  q_bf16 / kv_bf16 select bfloat16 (1) or float32
// (0).  Returns the CUDA error of the launch (0 on success).
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* pages,
    const void* lengths, void* out, void* part, void* tickets, int q_bf16,
    int kv_bf16, int batch, int hkv, int g, int dh, int num_pages,
    int page_size, int max_pages, long long q_sb, long long q_sh,
    long long k_sp, long long k_sl, long long k_sh, long long v_sp,
    long long v_sl, long long v_sh, long long part_floats, float scale,
    void* stream) {
  if (num_pages < 1 || page_size < 1 || max_pages < 1 ||
      static_cast<long long>(max_pages) * page_size > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = check_shape(batch, hkv, g, dh, kv_bf16 ? 2 : 4,
                            max_pages * page_size, part_floats))
    return err;
  const Layout kl{k_sp, k_sl, k_sh}, vl{v_sp, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = kv_bf16 ? run<__nv_bfloat16> : run<float>;
  return go(q, k, v, pages, lengths, out, part, tickets, q_bf16, batch, hkv,
            g, dh, num_pages, page_size, max_pages, q_sb, q_sh, kl, vl, scale,
            s);
}
