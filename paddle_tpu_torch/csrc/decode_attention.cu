// Single-token decode attention over a dense, length-masked KV cache for
// Hopper (sm_90a), bf16 or fp16, f32 online softmax.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_decode_kernel (launched
// by _decode_gqa).  Same contract: q [B, H, D] is the new token's query,
// the caches [B, S, Hkv, D] already hold its k/v, lengths[b] counts the
// valid positions including it; GQA native (query head h = hk * G + g);
// lengths[b] == 0 gives zeros.
//
// What bounds it: each (slot, kv head) reads its K/V rows once and does
// 4 * G * D FLOPs per position, about G FLOP per byte, so device memory
// bandwidth bounds it by two orders of magnitude.  The design reads only
// the positions below lengths[b] (the TPU kernel streams the whole
// capacity and masks it), and keeps many 16-byte loads in flight: one
// block per (kv head, slot) whose warps split the sequence, each warp
// covering several positions per step (D / 8 lanes per position, one
// 16-byte vector per lane) with an unrolled batch of loads started before
// any arithmetic.  Each position slot keeps its own (m, l, acc) and the
// slots are merged through shared memory in a fixed order, so the
// result does not depend on scheduling.  Not done yet: splitting one
// long slot across several blocks when B * Hkv is below the SM count.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ void to_float8(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void to_float8<__nv_bfloat16>(const uint4& raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void to_float8<__half>(const uint4& raw, float* out) {
  const __half2* p = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

template <int G>
struct Shape {
  static constexpr int kWarps = G <= 2 ? 16 : 8;
  static constexpr int kUnroll = G <= 2 ? 4 : 2;
  static constexpr int kThreads = kWarps * 32;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(Shape<G>::kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ lengths,
                  T* __restrict__ o, int S, int Hkv, float scale) {
  constexpr int kWarps = Shape<G>::kWarps;
  constexpr int kUnroll = Shape<G>::kUnroll;
  constexpr int kLanesPerPos = D / 8;              // one 16-byte vector each
  constexpr int kPosPerWarp = 32 / kLanesPerPos;
  constexpr int kSlots = kWarps * kPosPerWarp;     // positions in flight per step
  extern __shared__ __align__(16) float smem[];
  float* s_m = smem;                       // [kSlots][G]
  float* s_l = s_m + kSlots * G;           // [kSlots][G]
  float* s_acc = s_l + kSlots * G;         // [kWarps][G][D]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerPos;
  const int dl = lane % kLanesPerPos;
  const int slot = warp * kPosPerWarp + grp;
  const int H = Hkv * G;
  const int len = min(max(lengths[b], 0), S);

  // this lane's 8 elements of each query row, pre-scaled
  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + (static_cast<long>(b) * H + hk * G + g) * D + dl * 8);
    to_float8<T>(raw, qv[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] *= scale;
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const long row = static_cast<long>(Hkv) * D;
  const T* kb = kc + static_cast<long>(b) * S * row + static_cast<long>(hk) * D + dl * 8;
  const T* vb = vc + static_cast<long>(b) * S * row + static_cast<long>(hk) * D + dl * 8;

  // the loop bound is warp-uniform so every lane reaches the shuffles
  for (int base = warp * kPosPerWarp; base < len; base += kSlots * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + grp + u * kSlots;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < len) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + j * row);
        vr[u] = *reinterpret_cast<const uint4*>(vb + j * row);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + grp + u * kSlots < len;
      float kf[8], vf[8];
      to_float8<T>(kr[u], kf);
      to_float8<T>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qv[g][e], kf[e], part);
#pragma unroll
        for (int off = 1; off < kLanesPerPos; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (valid) {
          const float mn = fmaxf(m[g], part);
          const float alpha = __expf(m[g] - mn);
          const float p = __expf(part - mn);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(acc[g][e], alpha, p * vf[e]);
          m[g] = mn;
        }
      }
    }
  }

  // merge the position slots: global max, rescale, sum in a fixed order
  if (dl == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s_m[slot * G + g] = m[g];
      s_l[slot * G + g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = kNeg;
    for (int sidx = 0; sidx < kSlots; ++sidx) mx = fmaxf(mx, s_m[sidx * G + g]);
    const float f = __expf(m[g] - mx);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float a = acc[g][e] * f;
      // sum the warp's position slots: lanes with the same dl
#pragma unroll
      for (int off = kLanesPerPos; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[g][e] = a;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s_acc[(warp * G + g) * D + dl * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += Shape<G>::kThreads) {
    const int g = idx / D;
    float mx = kNeg;
    for (int sidx = 0; sidx < kSlots; ++sidx) mx = fmaxf(mx, s_m[sidx * G + g]);
    float denom = 0.f;
    for (int sidx = 0; sidx < kSlots; ++sidx)
      denom += s_l[sidx * G + g] * __expf(s_m[sidx * G + g] - mx);
    float num = 0.f;
    for (int w = 0; w < kWarps; ++w) num += s_acc[w * G * D + idx];
    o[(static_cast<long>(b) * H + hk * G) * D + idx] =
        from_float<T>(num / fmaxf(denom, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int S, int Hkv, cudaStream_t stream) {
  constexpr int kSlots = Shape<G>::kWarps * (32 / (D / 8));
  constexpr size_t smem =
      (2 * kSlots * G + static_cast<size_t>(Shape<G>::kWarps) * G * D) * sizeof(float);
  // within the 48 KB a launch may take without cudaFuncSetAttribute
  static_assert(smem <= 48 * 1024, "decode tile exceeds default shared memory");
  dim3 grid(Hkv, B);
  decode_kernel<T, D, G><<<grid, Shape<G>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), S, Hkv, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const void* q, const void* k, const void* v, const void* lengths,
             void* o, int B, int S, int G, int Hkv, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, o, B, S, Hkv, st);
    case 2: return launch<T, D, 2>(q, k, v, lengths, o, B, S, Hkv, st);
    case 4: return launch<T, D, 4>(q, k, v, lengths, o, B, S, Hkv, st);
    case 8: return launch<T, D, 8>(q, k, v, lengths, o, B, S, Hkv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, D], k/v caches [B, S, Hkv, D], lengths [B] int32, all
// contiguous; o [B, H, D].  H / Hkv in {1, 2, 4, 8}, D in {64, 128}.
// dtype: 0 = bf16, 1 = fp16.  Returns a cudaError_t: 0 when the launch
// was accepted.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int S,
                                int H, int Hkv, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  if (dtype == 0 && D == 128)
    return by_group<__nv_bfloat16, 128>(q, k, v, lengths, o, B, S, G, Hkv, st);
  if (dtype == 0 && D == 64)
    return by_group<__nv_bfloat16, 64>(q, k, v, lengths, o, B, S, G, Hkv, st);
  if (dtype == 1 && D == 128)
    return by_group<__half, 128>(q, k, v, lengths, o, B, S, G, Hkv, st);
  if (dtype == 1 && D == 64)
    return by_group<__half, 64>(q, k, v, lengths, o, B, S, G, Hkv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
