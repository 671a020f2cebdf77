// Fused single-query GQA decode attention over a contiguous int8 KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/decode_int8.py
// :: quantized_decode_attention (body _quantized_decode_kernel, GQA wrapper
// quantized_gqa_decode_attention): the cache holds int8 codes with one f32
// scale per (token, KV head), written once when the token enters the cache;
// the kernel only reads and dequantizes.
//
// Bound: device-memory bytes.  A key costs 2 * (dh + 4) bytes per KV head
// (codes and scale, for K and V) against 2 * dh * 4 for an f32 cache, about
// 3.9x fewer at dh 128.  The codes are copied into the warp tiles of
// decode_body.cuh with 16-byte cp.async copies (16 codes each, so dh must be
// a multiple of 16) and the scales with 4-byte ones beside them; q.k is
// taken over the codes in f32 registers and scaled once per key by its K
// scale, and each key's V scale is folded into its probability before p.v.
// Numerics follow the TPU kernel: q stays in f32 (it is not rounded to the
// cache type), the products and the probabilities are f32, and the output
// is cast to q's type at the end.  The split keys and the in-kernel
// combine of the contiguous kernel are shared, and so are its softmax
// statistics on request: the block that writes a row's output writes its
// max m and sum l (decode_body.cuh), which a cache split by sequence over
// ranks combines across its segments.

#include "decode_body.cuh"

namespace {

int run(const void* q, const void* kq, const void* ks, const void* vq,
        const void* vs, const void* lengths, void* stats, void* out,
        void* part,
        void* tickets, int q_bf16, int batch, int hkv, int g, int dh,
        int cache_len, int span, long long q_sb, long long q_sh, Layout kl,
        Layout ksl, Layout vl, Layout vsl, float scale, cudaStream_t stream) {
  Args<int8_t> a = make_args<int8_t>(q, out, q_bf16, kq, vq, lengths, part,
                                     tickets, hkv, g, dh, cache_len, span,
                                     q_sb, q_sh, kl, vl, scale);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ksl = ksl;
  a.vsl = vsl;
  a.stats = static_cast<float*>(stats);
  return launch<int8_t, false>(a, batch, stream);
}

}  // namespace

// C entry, bound with ctypes.  q: (B, Hq, dh) with strides (q_sb, q_sh, 1);
// kq, vq: int8 (B, L, Hkv, dh) with strides (sb, sl, sh, 1), 16-byte aligned
// rows; ks, vs: f32 (B, L, Hkv) with strides (sb, sl, sh); lengths: (B,)
// int32; stats: null, or a contiguous (2, B, Hq) f32 array that receives
// each row's softmax max m and sum l; out: contiguous (B, Hq, dh) of q's
// type, q_bf16 selecting bfloat16 (1) or float32 (0); span, part,
// part_floats and tickets as for decode_attention.  Returns the CUDA error
// of the launch.
extern "C" int quantized_decode_attention(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* lengths, void* stats, void* out, void* part,
    void* tickets, int q_bf16, int batch, int hkv, int g, int dh,
    int cache_len, int span, long long q_sb, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long ks_sb, long long ks_sl,
    long long ks_sh, long long v_sb, long long v_sl, long long v_sh,
    long long vs_sb, long long vs_sl, long long vs_sh, long long part_floats,
    float scale, void* stream) {
  if (int err = check_shape(batch, hkv, g, dh, 1, cache_len, span,
                            part_floats))
    return err;
  const Layout kl{k_sb, k_sl, k_sh}, ksl{ks_sb, ks_sl, ks_sh};
  const Layout vl{v_sb, v_sl, v_sh}, vsl{vs_sb, vs_sl, vs_sh};
  return run(q, kq, ks, vq, vs, lengths, stats, out, part, tickets, q_bf16,
             batch, hkv, g, dh, cache_len, span, q_sb, q_sh, kl, ksl, vl, vsl,
             scale, static_cast<cudaStream_t>(stream));
}
