// Window attention over a dense KV cache for Hopper (sm_90a), bf16 or
// fp16, f32 online softmax: W new tokens per slot, query i attending
// positions j <= lengths[b] + i (the spec-decode verify window and the
// chunked-prefill chunk).
//
// Replaces: paddle_tpu/ops/decode_attention.py:_window_kernel (launched by
// _window_gqa).  Same contract: q [B, W, H, D], caches [B, S, Hkv, D] that
// already hold the window's k/v, lengths [B] counting the tokens cached
// before the window; GQA native.  q and o are read and written in place:
// the TPU wrapper's transposes to [B * Hkv, W * G, D] are layout work for
// the TPU.
//
// What bounds it: a verify window (W * G = 5 rows) reads each kv head's
// K/V once for about 4 * W * G * D FLOPs per position: device memory
// bandwidth.  A prefill chunk (512 rows) does 512x that work on the same
// bytes: the tensor cores.  The designs, in window_attention.cuh: the
// verify runs a ring of 128-key K/V tiles that one producer warp keeps
// full by TMA (up to 192 KB a block in flight) while eight mma.sync
// consumer warps take 16 keys of each tile, with the key tiles of a (slot,
// kv head) split over a cluster of CTAs when B * Hkv leaves SMs idle; a
// chunk runs the shared wgmma mainloop of hopper_attn_fwd.cuh.  Both read
// key tiles only up to the block's highest limit.
#include "window_attention.cuh"

// q [B, W, H, D], k/v caches [B, S, Hkv, D], lengths [B] int32, all
// contiguous; o [B, W, H, D].  H % Hkv == 0, D in {64, 128}.  dtype: 0 =
// bf16, 1 = fp16.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int window_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int W,
                                int S, int H, int Hkv, int D, int dtype,
                                void* stream) {
  window_attn::Args a{q, k, v, nullptr, nullptr, nullptr, lengths, o,
                      B, W, S, H, Hkv, D, 0, 0, dtype, stream};
  return window_attn::run<void, false>(a);
}
