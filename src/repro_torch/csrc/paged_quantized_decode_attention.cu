// Fused single-query GQA decode attention through a paged int8 KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/decode_int8.py
// :: paged_quantized_gqa_decode_attention (body
// _paged_quantized_decode_kernel): int8 codes and their f32 scales live in
// pages of pools shared by all sequences (codes (num_pages, page_size, Hkv,
// dh), scales (num_pages, page_size, Hkv)), and key t of sequence b is row
// t % page_size of pool page pages[b, t / page_size], clamped to
// [0, num_pages).
//
// Bound: device-memory bytes, 2 * (dh + 4) per valid key and KV head plus
// the page table, about 3.9x fewer than an f32 cache at dh 128.  The design
// is the contiguous int8 kernel's (quantized_decode_attention.cu) with the
// page walk of paged_decode_attention.cu: each warp reads the page table
// itself as it copies each key row's codes and scale into its tile, so any
// page_size >= 1 works, and the split keys and in-kernel combine of
// decode_body.cuh read the keys in the contiguous order.

#include "decode_body.cuh"

namespace {

int run(const void* q, const void* kq, const void* ks, const void* vq,
        const void* vs, const void* pages, const void* lengths, void* out,
        void* part, void* tickets, int q_bf16, int batch, int hkv, int g,
        int dh, int num_pages, int page_size, int max_pages, long long q_sb,
        long long q_sh, Layout kl, Layout ksl, Layout vl, Layout vsl,
        float scale, cudaStream_t stream) {
  Args<int8_t> a = make_args<int8_t>(q, out, q_bf16, kq, vq, lengths, part,
                                     tickets, hkv, g, dh,
                                     max_pages * page_size, q_sb, q_sh, kl,
                                     vl, scale);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ksl = ksl;
  a.vsl = vsl;
  a.pages = {static_cast<const int*>(pages), max_pages, page_size,
             num_pages};
  return launch<int8_t, true>(a, batch, stream);
}

}  // namespace

// C entry, bound with ctypes.  q: (B, Hq, dh) with strides (q_sb, q_sh, 1);
// kq, vq: int8 pools (num_pages, page_size, Hkv, dh) with strides (sp, sl,
// sh, 1), 16-byte aligned rows; ks, vs: f32 pools (num_pages, page_size,
// Hkv) with strides (sp, sl, sh); pages: contiguous (B, max_pages) int32,
// -1 = no page; lengths: (B,) int32; out: contiguous (B, Hq, dh) of q's
// type, q_bf16 selecting bfloat16 (1) or float32 (0); part, part_floats and
// tickets as for decode_attention, with L = max_pages * page_size.  Returns
// the CUDA error of the launch.
extern "C" int paged_quantized_decode_attention(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* pages, const void* lengths, void* out,
    void* part, void* tickets, int q_bf16, int batch, int hkv, int g, int dh,
    int num_pages, int page_size, int max_pages, long long q_sb,
    long long q_sh, long long k_sp, long long k_sl, long long k_sh,
    long long ks_sp, long long ks_sl, long long ks_sh, long long v_sp,
    long long v_sl, long long v_sh, long long vs_sp, long long vs_sl,
    long long vs_sh, long long part_floats, float scale, void* stream) {
  if (num_pages < 1 || page_size < 1 || max_pages < 1 ||
      static_cast<long long>(max_pages) * page_size > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = check_shape(batch, hkv, g, dh, 1, max_pages * page_size,
                            part_floats))
    return err;
  const Layout kl{k_sp, k_sl, k_sh}, ksl{ks_sp, ks_sl, ks_sh};
  const Layout vl{v_sp, v_sl, v_sh}, vsl{vs_sp, vs_sl, vs_sh};
  return run(q, kq, ks, vq, vs, pages, lengths, out, part, tickets, q_bf16,
             batch, hkv, g, dh, num_pages, page_size, max_pages, q_sb, q_sh,
             kl, ksl, vl, vsl, scale, static_cast<cudaStream_t>(stream));
}
