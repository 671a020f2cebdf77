// Fused single-query GQA decode attention over a contiguous KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/decode.py ::
// decode_attention (body _decode_kernel, GQA wrapper gqa_decode_attention):
// one new token per sequence attends over its own valid cache prefix.
//
// The body, its bound (device-memory bytes: 2 * dh * element size per key
// and KV head) and what the design does about it are in decode_body.cuh.
// The cache is read in its (B, L, Hkv, dh) layout through strides, so the
// caller never copies it into the TPU kernel's (B*Hkv, L, dh) fold.

#include "decode_body.cuh"

namespace {

template <typename QT, typename KT>
int run(const void* q, const void* k, const void* v, const void* lengths,
        void* out, int batch, int hkv, int g, int dh, int cache_len,
        long long q_sb, long long q_sh, Layout kl, Layout vl, float scale,
        cudaStream_t stream) {
  const Args<KT> a = make_args<KT>(q, out, k, v, lengths, hkv, g, dh,
                                   cache_len, q_sb, q_sh, kl, vl, scale);
  return launch<QT, KT, false>(a, batch, stream);
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
  if (int err = check_shape(batch, hkv, g, dh, kv_bf16 ? 2 : 4)) return err;
  const Layout kl{k_sb, k_sl, k_sh}, vl{v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return run<bf16, bf16>(q, k, v, lengths, out, batch, hkv, g, dh,
                           cache_len, q_sb, q_sh, kl, vl, scale, s);
  if (q_bf16)
    return run<bf16, float>(q, k, v, lengths, out, batch, hkv, g, dh,
                            cache_len, q_sb, q_sh, kl, vl, scale, s);
  if (kv_bf16)
    return run<float, bf16>(q, k, v, lengths, out, batch, hkv, g, dh,
                            cache_len, q_sb, q_sh, kl, vl, scale, s);
  return run<float, float>(q, k, v, lengths, out, batch, hkv, g, dh,
                           cache_len, q_sb, q_sh, kl, vl, scale, s);
}
