// The 8-bit codes of a quantized KV cache, as the attention kernels read
// them (decode_attention.cuh, window_attention.cuh): int8 codes
// (ops/quantized_matmul.py quantize_kv, 'int8') or e4m3 codes ('fp8',
// torch.float8_e4m3fn), each with one f32 scale per (position, kv head).
// Code<KV>::kQuant names a code type; 16-bit cache types are not codes.
//
// A kernel reads codes four to a 32-bit word: prep() once per word, then
// at(w, i) gives byte i as the exact f32 code and pair(w, i) bytes i and
// i + 1 (i even).  int8 goes through a byte permute and one subtraction
// (0x4B0000uu is 2^23 + uu with uu = code + 128, after prep's XOR), in
// place of the quarter-rate I2F.  e4m3 goes through the hardware's
// cvt.rn.f16x2.e4m3x2, two codes an instruction; every e4m3 value is
// exact in f16, so the f32 it widens to is exact too.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace kv_codes {

template <typename KV>
struct Code {
  static constexpr bool kQuant = false;
};

template <>
struct Code<int8_t> {
  static constexpr bool kQuant = true;
  __device__ static __forceinline__ uint32_t prep(uint32_t w) { return w ^ 0x80808080u; }
  __device__ static __forceinline__ float at(uint32_t w, int i) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + i)) - 8388736.f;
  }
  __device__ static __forceinline__ float2 pair(uint32_t w, int i) {
    return make_float2(at(w, i), at(w, i + 1));
  }
};

template <>
struct Code<__nv_fp8_e4m3> {
  static constexpr bool kQuant = true;
  __device__ static __forceinline__ uint32_t prep(uint32_t w) { return w; }
  __device__ static __forceinline__ float2 pair(uint32_t w, int i) {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> (8 * i)), __NV_E4M3);
    return __half22float2(__half2(h));
  }
  __device__ static __forceinline__ float at(uint32_t w, int i) {
    const __half_raw h =
        __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(w >> (8 * i)), __NV_E4M3);
    return __half2float(__half(h));
  }
};

}  // namespace kv_codes
