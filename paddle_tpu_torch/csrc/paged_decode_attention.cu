// Single-token decode attention over a paged KV cache (a block pool read
// through per-slot block tables) for Hopper (sm_90a), bf16 or fp16, f32
// online softmax.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_paged_kernel (launched
// by _paged_gqa).  Same contract: q [B, H, D]; pools [NB, bs, Hkv, D]
// that already hold the new token's k/v; tables [B, MB] int32 of pool
// block ids (entries past a slot's extent point at the null block 0);
// lengths [B] int32 counting the valid positions including the new one.
// Position t of slot b lives at pool[tables[b, t / bs], t % bs].  An
// inactive slot (table row all 0, length 1) reads block 0 and its output
// is ignored.
//
// What bounds it: device memory bandwidth, as the dense kernel: the same
// bytes, read through the table.  Each position's D values are
// contiguous, so the 16-byte loads of the dense design carry over; the
// slot's table entries below ceil(len / bs) are copied into shared
// memory once, and blocks past the slot's length are never touched
// (decode_attention.cuh).  The TPU kernel walks every table entry with
// a grid step each.
#include "decode_attention.cuh"

// q [B, H, D]; k_pool/v_pool [NB, bs, Hkv, D]; tables [B, MB] int32;
// lengths [B] int32; all contiguous; o [B, H, D].  H % Hkv == 0, D in
// {64, 128}, bs a multiple of 16.  dtype: 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* o, int B,
                                      int MB, int bs, int H, int Hkv, int D,
                                      int dtype, void* stream) {
  decode_attn::Args a{q, k_pool, v_pool, nullptr, nullptr, tables, lengths, o,
                      B, 0, H, Hkv, D, bs, MB, dtype, stream};
  return decode_attn::run<void, true>(a);
}
