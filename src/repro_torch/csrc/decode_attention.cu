// Fused single-query GQA decode attention over a contiguous KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/decode.py ::
// decode_attention (body _decode_kernel, GQA wrapper gqa_decode_attention):
// one new token per sequence attends over its own valid cache prefix.
//
// The body, its bound (device-memory bytes: 2 * dh * element size per key
// and KV head) and what the design does about it (keys split across
// blocks, partials combined by the last block of each row) are in
// decode_body.cuh.  The cache is read in its (B, L, Hkv, dh) layout through
// strides, so the caller never copies it into the TPU kernel's
// (B*Hkv, L, dh) fold.

#include "decode_body.cuh"

namespace {

template <typename KT>
int run(const void* q, const void* k, const void* v, const void* lengths,
        void* stats, void* out, void* part, void* tickets, int q_bf16,
        int batch, int hkv, int g, int dh, int cache_len, int span,
        long long q_sb, long long q_sh, Layout kl, Layout vl, float scale,
        cudaStream_t stream) {
  Args<KT> a = make_args<KT>(q, out, q_bf16, k, v, lengths, part, tickets,
                             hkv, g, dh, cache_len, span, q_sb, q_sh, kl, vl,
                             scale);
  a.stats = static_cast<float*>(stats);
  return launch<KT, false>(a, batch, stream);
}

}  // namespace

// C entry, bound with ctypes.  q: (B, Hq, dh) with strides (q_sb, q_sh, 1);
// k, v: (B, L, Hkv, dh) with strides (sb, sl, sh, 1), 16-byte aligned rows;
// lengths: (B,) int32; stats: null, or a contiguous (2, B, Hq) f32 array
// that receives each row's softmax max m and sum l (decode_body.cuh);
// out: contiguous (B, Hq, dh) of q's type; span: the
// keys of a split (>= 1); part: an f32 workspace of part_floats >= B * Hkv
// * split_count(L, span) * g * (dh + 2) floats, sized for this call's
// span; tickets: (B * Hkv,) int32, zero (the kernel leaves it zero).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* stats, void* out, void* part, void* tickets, int q_bf16,
    int kv_bf16, int batch,
    int hkv, int g, int dh, int cache_len, int span, long long q_sb,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long part_floats, float scale,
    void* stream) {
  if (int err = check_shape(batch, hkv, g, dh, kv_bf16 ? 2 : 4, cache_len,
                            span, part_floats))
    return err;
  const Layout kl{k_sb, k_sl, k_sh}, vl{v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = kv_bf16 ? run<__nv_bfloat16> : run<float>;
  return go(q, k, v, lengths, stats, out, part, tickets, q_bf16, batch, hkv,
            g, dh, cache_len, span, q_sb, q_sh, kl, vl, scale, s);
}
