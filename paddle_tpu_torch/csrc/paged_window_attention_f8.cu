// Window attention over a paged fp8 (e4m3) KV cache (e4m3 value pools and
// f32 scale pools read through per-slot block tables) for Hopper
// (sm_90a); q and o bf16 or fp16.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_paged_window_composite,
// the composite the JAX package's fp8 pools ride (behind the int8 gate
// of paged_decode_attention_window); there is no TPU kernel for them.  Same contract as paged_window_attention_q.cu, with pools of
// e4m3 codes and scale pools [NB, bs, Hkv] f32 read in place.  Each K/V
// tile is dequantized to q's dtype before the products.
//
// What bounds it: as window_attention_f8.cu, the code and scale bytes of
// a verify window, the operations of a chunk; the paged int8 kernel's
// design (window_attention.cuh: one TMA box per pool segment, the table
// walked once per segment for the scales) with the e4m3 conversion.
#include "window_attention.cuh"

// q [B, W, H, D]; k_pool/v_pool [NB, bs, Hkv, D] e4m3; k_scale/v_scale
// [NB, bs, Hkv] f32; tables [B, MB] int32; lengths [B] int32; all
// contiguous; o [B, W, H, D].  H % Hkv == 0, D in {64, 128}, bs a
// multiple of 16.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int paged_window_attention_f8(const void* q, const void* k_pool,
                                         const void* v_pool, const void* k_scale,
                                         const void* v_scale, const void* tables,
                                         const void* lengths, void* o, int B,
                                         int W, int MB, int bs, int H, int Hkv,
                                         int D, int dtype, void* stream) {
  window_attn::Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o,
                      B, W, 0, H, Hkv, D, bs, MB, dtype, stream};
  return window_attn::run<__nv_fp8_e4m3, true>(a);
}
