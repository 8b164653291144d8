// Check entries for the attention-dropout bits of the flash kernels; no
// kernel of a path.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel, _bwd_dq_kernel
// and _bwd_dkv_kernel only in what they lack: those TPU kernels take no
// dropout (the JAX package drops attention probabilities in its
// composite, nn/functional/attention.py:_sdpa_reference, with
// jax.random.bernoulli bits).  The port's rows 1-3 draw Philox4x32-10
// bits (philox.cuh) inside the kernels instead; these two entries let a
// check read those bits on the card:
// - philox_words: Philox4x32-10 of given counters and keys, beside
//   curand_Philox4x32_10 from the toolkit's curand_kernel.h (header
//   only, used here and nowhere on a path);
// - flash_keep_bits: the keep bit of every element (b, h, i, j) of one
//   attention call, each from philox.cuh's Dropout::keep alone.
//
// What bounds it: nothing that matters; one thread an element (or a
// counter), off every path.
#include <cstdint>

#include <curand_kernel.h>

#include "philox.cuh"

namespace {

__global__ void philox_words_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const uint32_t* x = in + 6 * t;
  const uint4 c = make_uint4(x[0], x[1], x[2], x[3]);
  const uint2 k = make_uint2(x[4], x[5]);
  const uint4 ours = philox::philox4x32_10(c, k);
  const uint4 ref = curand_Philox4x32_10(c, k);
  uint32_t* y = out + 8 * t;
  y[0] = ours.x;
  y[1] = ours.y;
  y[2] = ours.z;
  y[3] = ours.w;
  y[4] = ref.x;
  y[5] = ref.y;
  y[6] = ref.z;
  y[7] = ref.w;
}

__global__ void keep_bits_kernel(const int64_t* __restrict__ pair,
                                 uint8_t* __restrict__ out, int H, int S,
                                 int Sk, uint32_t thr, long total) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % Sk);
  const int i = static_cast<int>((t / Sk) % S);
  const int bh = static_cast<int>(t / (static_cast<long>(S) * Sk));
  const philox::Dropout d(pair, bh, thr);
  out[t] = d.keep(i, j) ? 1 : 0;
}

}  // namespace

// in [n, 6] uint32 (c0, c1, c2, c3, k0, k1); out [n, 8] uint32: the four
// words of philox.cuh, then the four of curand_Philox4x32_10.
extern "C" int philox_words(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  philox_words_kernel<<<(n + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// pair: the (seed, offset) int64 pair in device memory; out [B, H, S, Sk]
// uint8, 1 where element (b, h, i, j) is kept at threshold thr.
extern "C" int flash_keep_bits(const void* pair, void* out, int B, int H,
                               int S, int Sk, int thr, void* stream) {
  if (!pair || B <= 0 || H <= 0 || S <= 0 || Sk <= 0 || thr < 0 ||
      thr > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const long total = static_cast<long>(B) * H * S * Sk;
  keep_bits_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(pair), static_cast<uint8_t*>(out), H, S,
      Sk, static_cast<uint32_t>(thr), total);
  return static_cast<int>(cudaGetLastError());
}
