// Window attention over a paged int8 KV cache (int8 value pools and f32
// scale pools read through per-slot block tables) for Hopper (sm_90a); q
// and o bf16 or fp16.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_paged_window_kernel_q
// (launched by _paged_window_gqa).  Same contract as
// paged_window_attention.cu, with pools of int8 codes and scale pools
// [NB, bs, Hkv] f32 read in place (the TPU wrapper transposes them to
// [NB, Hkv, bs] on every call).  Each K/V tile is dequantized to q's
// dtype before the products, as the TPU kernel does.
//
// What bounds it: as window_attention_q.cu, the bytes of the codes and
// scales.  The verify regime (vq::verify_q_kernel in window_attention.cuh)
// is the dense one's code ring with the pool's indirection kept off the
// consumers: the producer warp stages the slot's live table entries in
// shared memory once, issues one TMA box per pool segment of a 128-key
// tile (128, 64 or 16 positions, dividing bs), and walks the table once
// per segment for the scales, each position's row by shuffle.
#include "window_attention.cuh"

// q [B, W, H, D]; k_pool/v_pool [NB, bs, Hkv, D] int8; k_scale/v_scale
// [NB, bs, Hkv] f32; tables [B, MB] int32; lengths [B] int32; all
// contiguous; o [B, W, H, D].  H % Hkv == 0, D in {64, 128}, bs a
// multiple of 16.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int paged_window_attention_q(const void* q, const void* k_pool,
                                        const void* v_pool, const void* k_scale,
                                        const void* v_scale, const void* tables,
                                        const void* lengths, void* o, int B,
                                        int W, int MB, int bs, int H, int Hkv,
                                        int D, int dtype, void* stream) {
  window_attn::Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o,
                      B, W, 0, H, Hkv, D, bs, MB, dtype, stream};
  return window_attn::run<int8_t, true>(a);
}
