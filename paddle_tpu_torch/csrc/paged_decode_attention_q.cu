// Single-token decode attention over a paged int8 KV cache (int8 value
// pools and f32 scale pools read through per-slot block tables) for
// Hopper (sm_90a); q and o bf16 or fp16, f32 online softmax.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_paged_kernel_q
// (launched by _paged_gqa_q).  Same contract as the paged kernel, with
// pools [NB, bs, Hkv, D] of int8 codes and scale pools [NB, bs, Hkv] f32.
// The scale pools are read in place: the TPU wrapper transposes them to
// [NB, Hkv, bs] first, a pass over the whole scale pool on every call.
//
// What bounds it: device memory bandwidth on the int8 bytes: D codes
// plus one f32 scale per position and kv head for each of K and V.  The
// table walk of the paged kernel and the in-register dequantization of
// the dense int8 kernel, in one kernel (decode_attention.cuh).
#include "decode_attention.cuh"

// q [B, H, D]; k_pool/v_pool [NB, bs, Hkv, D] int8; k_scale/v_scale
// [NB, bs, Hkv] f32; tables [B, MB] int32; lengths [B] int32; all
// contiguous; o [B, H, D].  H % Hkv == 0, D in {64, 128}, bs a multiple
// of 16.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a cudaError_t:
// 0 when the launch was accepted.
extern "C" int paged_decode_attention_q(const void* q, const void* k_pool,
                                        const void* v_pool, const void* k_scale,
                                        const void* v_scale, const void* tables,
                                        const void* lengths, void* o, int B,
                                        int MB, int bs, int H, int Hkv, int D,
                                        int dtype, void* stream) {
  decode_attn::Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o,
                      B, 0, H, Hkv, D, bs, MB, dtype, stream};
  return decode_attn::run<int8_t, true>(a);
}
