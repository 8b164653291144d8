// Shared device code of the single-token decode-attention kernels
// (decode_attention.cu, decode_attention_q.cu, paged_decode_attention.cu,
// paged_decode_attention_q.cu): one kernel template over the cache layout
// (dense slot rows [B, S, Hkv, D], or pool blocks [NB, bs, Hkv, D]
// reached through a block table [B, MB]) and the value type (bf16/fp16,
// or int8 or e4m3 codes with one f32 scale per (position, kv head); the
// e4m3 forms are decode_attention_f8.cu and paged_decode_attention_f8.cu).
//
// Contract of every variant (the JAX package's): q [B, H, D] is the new
// token's query per slot, the cache already holds its k/v, lengths[b]
// counts the valid positions including it (clamped to the capacity), GQA
// native (query head h = hk * G + g), lengths[b] == 0 gives zeros.  Paged
// position t of slot b lives at pool[tables[b, t / bs], t % bs].
//
// Design: bandwidth-bound (about G FLOP per byte), so each block reads
// only the positions below lengths[b] and keeps many 16-byte loads in
// flight.  One block per (kv head, query chunk, slot) holds up to GC query
// rows of the kv head's group (GC <= 8 for 16-bit values, <= 4 for 8-bit
// codes, whose 16-byte vector carries 16 values; a group larger than GC is
// split over several blocks that each stream the kv head, so any G
// works).  Its warps split the sequence; D / kVec lanes share a position,
// one 16-byte vector each, and an unrolled batch of loads starts before
// any arithmetic.  8-bit codes are converted in registers (kv_codes.cuh)
// and the scale is applied once per position to the dot product and to
// p, so the arithmetic stays f32.  The paged variants copy the slot's
// table entries below ceil(len / bs) into shared memory once.  Each position slot keeps
// its own (m, l, acc) and the slots merge through shared memory in a
// fixed order, so results do not depend on scheduling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_codes.cuh"

namespace decode_attn {

using kv_codes::Code;

constexpr float kNeg = -1e30f;

// one 16-byte vector of cache values -> kN floats
template <typename V>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void to_float(const uint4& raw, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<__half> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void to_float(const uint4& raw, float* out) {
    const __half2* p = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(p[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ static __forceinline__ void to_float(const uint4& raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int kN = 16;
  __device__ static __forceinline__ void to_float(const uint4& raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const float2 f = Code<__nv_fp8_e4m3>::pair(w[i], j);
        out[4 * i + j] = f.x;
        out[4 * i + j + 1] = f.y;
      }
  }
};

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

// Small groups (the MHA serving shape) run 16 warps with 4 loads each in
// flight per lane: one block per (kv head, slot) is all the parallelism
// there is, so the block itself must hide the memory latency.  An 8-bit
// lane holds 16 values (twice a 16-bit lane's), so codes take 16 warps,
// and their 128-register cap, only for one query row.
template <typename KV, int GC>
struct Shape {
  static constexpr bool kQuant = Code<KV>::kQuant;
  static constexpr int kWarps = GC <= (kQuant ? 1 : 2) ? 16 : 8;
  static constexpr int kUnroll = GC <= 2 ? 4 : 2;
  static constexpr int kThreads = kWarps * 32;
};

template <typename T, typename KV>
struct Params {
  const T* q;
  const KV* k;
  const KV* v;
  const float* ks;      // codes only: [B, S, Hkv] dense, [NB, bs, Hkv] paged
  const float* vs;
  const int* tables;    // paged only: [B, mb]
  const int* lengths;   // [B]
  T* o;                 // [B, H, D]
  int S;                // positions a slot can hold: capacity, or mb * bs
  int Hkv, G, n_chunks;
  int bs, bs_shift, mb; // paged only; bs_shift = log2(bs) or -1
  float scale;
};

template <typename T, typename KV, int D, int GC, bool kPaged>
__global__ void __launch_bounds__((Shape<KV, GC>::kThreads))
    decode_kernel(const Params<T, KV> p) {
  using Sh = Shape<KV, GC>;
  constexpr bool kQuant = Sh::kQuant;
  constexpr int kWarps = Sh::kWarps;
  constexpr int kUnroll = Sh::kUnroll;
  constexpr int kVec = Vec<KV>::kN;                // values per 16-byte vector
  constexpr int kLanesPerPos = D / kVec;
  constexpr int kPosPerWarp = 32 / kLanesPerPos;
  constexpr int kSlots = kWarps * kPosPerWarp;     // positions in flight per step
  constexpr int kQVec = 16 / sizeof(T);            // q values per 16 bytes
  extern __shared__ __align__(16) float smem[];
  float* s_m = smem;                               // [kSlots][GC]
  float* s_l = s_m + kSlots * GC;                  // [kSlots][GC]
  float* s_acc = s_l + kSlots * GC;                // [kWarps][GC][D]
  int* s_tbl = reinterpret_cast<int*>(s_acc + kWarps * GC * D);  // [mb]

  const int chunk = blockIdx.x % p.n_chunks;
  const int hk = blockIdx.x / p.n_chunks;
  const int b = blockIdx.y;
  const int g0 = chunk * GC;
  const int gn = min(GC, p.G - g0);                // query rows of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerPos;
  const int dl = lane % kLanesPerPos;
  const int slot = warp * kPosPerWarp + grp;
  const int H = p.Hkv * p.G;
  const int len = min(max(p.lengths[b], 0), p.S);

  if constexpr (kPaged) {
    const int n_blk = (len + p.bs - 1) / p.bs;
    for (int i = threadIdx.x; i < n_blk; i += Sh::kThreads)
      s_tbl[i] = p.tables[static_cast<long>(b) * p.mb + i];
    __syncthreads();
  }

  // this lane's kVec elements of each query row, pre-scaled (rows past
  // gn stay zero and are never written out)
  const T* qb = p.q + (static_cast<long>(b) * H + hk * p.G + g0) * D + dl * kVec;
  float qv[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) qv[g][e] = 0.f;
    if (g < gn) {
#pragma unroll
      for (int i = 0; i < kVec / kQVec; ++i)
        Vec<T>::to_float(*reinterpret_cast<const uint4*>(qb + g * D + i * kQVec),
                         qv[g] + i * kQVec);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[g][e] *= p.scale;
    }
  }

  float m[GC], l[GC], acc[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  // cache row of position t: values at (row * Hkv + hk) * D, scale at
  // row * Hkv + hk
  auto row_of = [&](int t) -> long {
    if constexpr (kPaged) {
      const int bi = p.bs_shift >= 0 ? (t >> p.bs_shift) : (t / p.bs);
      return static_cast<long>(s_tbl[bi]) * p.bs + (t - bi * p.bs);
    } else {
      return static_cast<long>(b) * p.S + t;
    }
  };

  // the loop bound is warp-uniform so every lane reaches the shuffles
  for (int base = warp * kPosPerWarp; base < len; base += kSlots * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + grp + u * kSlots;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      if (j < len) {
        const long r = row_of(j) * p.Hkv + hk;
        kr[u] = *reinterpret_cast<const uint4*>(p.k + r * D + dl * kVec);
        vr[u] = *reinterpret_cast<const uint4*>(p.v + r * D + dl * kVec);
        if constexpr (kQuant) {
          ksc[u] = p.ks[r];
          vsc[u] = p.vs[r];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + grp + u * kSlots < len;
      float kf[kVec], vf[kVec];
      Vec<KV>::to_float(kr[u], kf);
      Vec<KV>::to_float(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qv[g][e], kf[e], part);
#pragma unroll
        for (int off = 1; off < kLanesPerPos; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if constexpr (kQuant) part *= ksc[u];
        if (valid) {
          const float mn = fmaxf(m[g], part);
          const float alpha = __expf(m[g] - mn);
          const float pr = __expf(part - mn);
          const float pv = kQuant ? pr * vsc[u] : pr;
          l[g] = l[g] * alpha + pr;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(acc[g][e], alpha, pv * vf[e]);
          m[g] = mn;
        }
      }
    }
  }

  // merge the position slots: global max, rescale, sum in a fixed order
  if (dl == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      s_m[slot * GC + g] = m[g];
      s_l[slot * GC + g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float mx = kNeg;
    for (int sidx = 0; sidx < kSlots; ++sidx) mx = fmaxf(mx, s_m[sidx * GC + g]);
    const float f = __expf(m[g] - mx);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
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
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        s_acc[(warp * GC + g) * D + dl * kVec + e] = acc[g][e];
  }
  __syncthreads();
  T* ob = p.o + (static_cast<long>(b) * H + hk * p.G + g0) * D;
  for (int idx = threadIdx.x; idx < gn * D; idx += Sh::kThreads) {
    const int g = idx / D;
    float mx = kNeg;
    for (int sidx = 0; sidx < kSlots; ++sidx) mx = fmaxf(mx, s_m[sidx * GC + g]);
    float denom = 0.f;
    for (int sidx = 0; sidx < kSlots; ++sidx)
      denom += s_l[sidx * GC + g] * __expf(s_m[sidx * GC + g] - mx);
    float num = 0.f;
    for (int w = 0; w < kWarps; ++w) num += s_acc[w * GC * D + idx];
    ob[idx] = from_float<T>(num / fmaxf(denom, 1e-30f));
  }
}

// What the C entry points pass: untyped pointers and sizes.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* tables;
  const void* lengths;
  void* o;
  int B, S, H, Hkv, D;
  int bs, mb;           // paged only
  int dtype;            // 0 = bf16, 1 = fp16
  void* stream;
};

template <typename T, typename KV, int D, int GC, bool kPaged>
int launch(const Args& a, int n_chunks, int bs_shift) {
  using Sh = Shape<KV, GC>;
  constexpr int kSlots = Sh::kWarps * (32 / (D / Vec<KV>::kN));
  const size_t smem = (2 * kSlots * GC + static_cast<size_t>(Sh::kWarps) * GC * D) * sizeof(float) +
                      (kPaged ? static_cast<size_t>(a.mb) * sizeof(int) : 0);
  auto kernel = decode_kernel<T, KV, D, GC, kPaged>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params<T, KV> p;
  p.q = static_cast<const T*>(a.q);
  p.k = static_cast<const KV*>(a.k);
  p.v = static_cast<const KV*>(a.v);
  p.ks = static_cast<const float*>(a.ks);
  p.vs = static_cast<const float*>(a.vs);
  p.tables = static_cast<const int*>(a.tables);
  p.lengths = static_cast<const int*>(a.lengths);
  p.o = static_cast<T*>(a.o);
  p.S = kPaged ? a.mb * a.bs : a.S;
  p.Hkv = a.Hkv;
  p.G = a.H / a.Hkv;
  p.n_chunks = n_chunks;
  p.bs = a.bs;
  p.bs_shift = bs_shift;
  p.mb = a.mb;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  dim3 grid(a.Hkv * n_chunks, a.B);
  kernel<<<grid, Sh::kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Query rows per block: the smallest power of two >= G, at most kMaxGC;
// a larger group is split over ceil(G / GC) blocks per kv head.
template <typename T, typename KV, int D, bool kPaged>
int by_group(const Args& a, int bs_shift) {
  constexpr int kMaxGC = Code<KV>::kQuant ? 4 : 8;
  const int G = a.H / a.Hkv;
  int gc = 1;
  while (gc < G && gc < kMaxGC) gc <<= 1;
  const int n = (G + gc - 1) / gc;
  switch (gc) {
    case 1: return launch<T, KV, D, 1, kPaged>(a, n, bs_shift);
    case 2: return launch<T, KV, D, 2, kPaged>(a, n, bs_shift);
    case 4: return launch<T, KV, D, 4, kPaged>(a, n, bs_shift);
    default:
      if constexpr (kMaxGC == 8) return launch<T, KV, D, 8, kPaged>(a, n, bs_shift);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The entry points' dispatch: value type (KV = T when C is void, else
// the codes C: int8_t or __nv_fp8_e4m3), dtype of q and o, D in {64,
// 128}.  Returns a cudaError_t.
template <typename C, bool kPaged>
int run(const Args& a) {
  if (a.B <= 0 || a.Hkv <= 0 || a.H <= 0 || a.H % a.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int bs_shift = -1;
  if constexpr (kPaged) {
    if (a.bs <= 0 || a.bs % 16 != 0 || a.mb <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if ((a.bs & (a.bs - 1)) == 0)
      for (bs_shift = 0; (1 << bs_shift) < a.bs; ++bs_shift) {
      }
  } else {
    if (a.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  using BF = __nv_bfloat16;
  using FH = __half;
  constexpr bool kQuant = !std::is_void<C>::value;
  using KB = typename std::conditional<kQuant, C, BF>::type;
  using KH = typename std::conditional<kQuant, C, FH>::type;
  if (a.dtype == 0 && a.D == 128) return by_group<BF, KB, 128, kPaged>(a, bs_shift);
  if (a.dtype == 0 && a.D == 64) return by_group<BF, KB, 64, kPaged>(a, bs_shift);
  if (a.dtype == 1 && a.D == 128) return by_group<FH, KH, 128, kPaged>(a, bs_shift);
  if (a.dtype == 1 && a.D == 64) return by_group<FH, KH, 64, kPaged>(a, bs_shift);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode_attn
