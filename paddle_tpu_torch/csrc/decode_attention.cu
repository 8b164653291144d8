// Single-token decode attention over a dense, length-masked KV cache for
// Hopper (sm_90a), bf16 or fp16, f32 online softmax.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_decode_kernel (launched
// by _decode_gqa).  Same contract: q [B, H, D] is the new token's query,
// the caches [B, S, Hkv, D] already hold its k/v, lengths[b] counts the
// valid positions including it; GQA native (query head h = hk * G + g)
// for any G = H / Hkv; lengths[b] == 0 gives zeros.
//
// What bounds it: each (slot, kv head) reads its K/V rows once and does
// 4 * G * D FLOPs per position, about G FLOP per byte, so device memory
// bandwidth bounds it by two orders of magnitude.  The design, shared
// with the int8 and paged variants, is in decode_attention.cuh: only the
// positions below lengths[b] are read (the TPU kernel streams the whole
// capacity and masks it), with many 16-byte loads in flight.  Not done
// yet: splitting one long slot across several blocks when B * Hkv is
// below the SM count.
#include "decode_attention.cuh"

// q [B, H, D], k/v caches [B, S, Hkv, D], lengths [B] int32, all
// contiguous; o [B, H, D].  H % Hkv == 0, D in {64, 128}.  dtype: 0 =
// bf16, 1 = fp16.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int S,
                                int H, int Hkv, int D, int dtype, void* stream) {
  decode_attn::Args a{q, k, v, nullptr, nullptr, nullptr, lengths, o,
                      B, S, H, Hkv, D, 0, 0, dtype, stream};
  return decode_attn::run<void, false>(a);
}
