// Window attention over a paged KV cache (block pools read through
// per-slot block tables) for Hopper (sm_90a), bf16 or fp16.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_paged_window_kernel
// (launched by _paged_window_gqa).  Same contract: q [B, W, H, D], pools
// [NB, bs, Hkv, D] that already hold the window's k/v at positions
// lengths[b] .. lengths[b] + W - 1 through tables [B, MB]; query i attends
// j <= min(lengths[b] + i, MB * bs - 1).  The TPU kernel walks every
// table entry as a grid step and masks; here a block copies the entries
// below ceil(min(lengths[b] + W, MB * bs) / bs) into shared memory once
// and reads the null block 0 for any position past them (padded rows,
// whose output is ignored), so a table entry past the slot's live blocks
// is never read and a key tile may span several blocks (bs = 16).
//
// What bounds it: as window_attention.cu (bytes for the verify,
// operations for a chunk).  The pool's indirection stays off the
// consumers: the producer issues one TMA box per pool segment of a key
// tile (128, 64 or 16 positions, dividing bs), its blocks worked out a
// tile ahead by one table walk per segment (window_attention.cuh).
#include "window_attention.cuh"

// q [B, W, H, D]; k_pool/v_pool [NB, bs, Hkv, D]; tables [B, MB] int32;
// lengths [B] int32; all contiguous; o [B, W, H, D].  H % Hkv == 0, D in
// {64, 128}, bs a multiple of 16.  dtype: 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int paged_window_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* o, int B,
                                      int W, int MB, int bs, int H, int Hkv,
                                      int D, int dtype, void* stream) {
  window_attn::Args a{q, k_pool, v_pool, nullptr, nullptr, tables, lengths, o,
                      B, W, 0, H, Hkv, D, bs, MB, dtype, stream};
  return window_attn::run<void, true>(a);
}
