// Shared device code of the fused per-layer decode step (the decode
// megakernel): decode_megakernel.cu, decode_megakernel_q.cu,
// paged_decode_megakernel.cu, paged_decode_megakernel_q.cu instantiate it
// over the cache layout (dense slot rows [B, cap, Hkv, D], or pool blocks
// [NB, bs, Hkv, D] through block tables [B, MB]) and the cache value type
// (the weights' bf16/fp16, or int8 codes with one f32 scale per (position,
// kv head)).
//
// Contract (the JAX package's _mega_kernel): x [B, H] is the residual
// stream of each slot's new token at this layer; the 12 layer arrays come
// in LAYER_WEIGHTS order (ln1 w/b, qkv w [H, H + 2 Hkv D] / b, out w
// [H, H] / b, ln2 w/b, up w [H, F] / b, down w [F, H] / b), weights [in,
// out]; lengths[b] counts the tokens cached BEFORE the new one.  The cache
// is read, never written: the new token's k/v are folded into the
// attention from the qkv product (through the int8 round trip when the
// cache is int8) and returned raw, for the caller to write.  Dense slots
// attend positions < min(len, cap - 1) plus the new token, paged slots
// positions < len.  Math: LayerNorm in f32; each product's input rounded
// to the weight type, f32 accumulation, f32 bias; attention in f32; tanh
// GELU in f32; x_out = (x2 + mlp) + b_down rounded to x's type.
//
// Design: one cooperative launch per layer step, a persistent grid of as
// many 512-thread blocks as fit on the card at once (one per SM), and
// seven phases separated by grid-wide barriers:
//   1 qkv = LN1(x) . W_qkv   (each block recomputes LN1's row statistics)
//   2 attention, one (slot, kv head) item per block: q and the new k/v
//     summed from the qkv partials, the slot's cache streamed once per
//     query head of the group, the new token folded last
//   3 o = attn . W_out
//   4 x2 = x + o + b_out and LN2, one slot per block
//   5 u = LN2(x2) . W_up
//   6 mlp = gelu(u + b_up) . W_down
//   7 x_out = x2 + mlp + b_down
// The products (phases 1, 3, 5, 6) are skinny: B <= 16 activation rows
// against a weight streamed once.  An item is a strip of 64 output columns
// over one chunk of the input dimension; the chunk count (split-K) is
// chosen by the wrapper so that strips x chunks fill the SMs (the 2048-
// column out and down projections run 4 chunks).  The activation chunk
// (16 rows, zero past B) sits in shared memory; weight tiles of 64 x 64
// stream through an 8-stage cp.async ring; mma.sync m16n8k16 with f32
// accumulation, 16 warps = 8 column tiles x 2 halves of each 64-row tile.
// Partial sums go to an f32 scratch in the L2 and are summed, chunk by
// chunk in a fixed order, by the phase that reads them: results do not
// depend on scheduling.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_attention.cuh"
#include "mma_tile.cuh"

namespace mega {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // activation rows of an mma tile: slots, zero past B
constexpr int kStrip = 64;      // output columns of a product item
constexpr int kTileK = 64;      // input rows of a streamed weight tile
constexpr int kStages = 8;      // weight tiles in the cp.async ring
constexpr int kMaxChunk = 2048; // input rows of one item at most
constexpr int kLdW = kStrip + 8;       // padded weight tile row (elements)
constexpr int kLdA = kMaxChunk + 8;    // padded activation row (elements)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the tanh GELU of the composed GPTMLP (jax.nn.gelu(approximate=True))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// shared memory of the products (phases 1, 3, 5, 6); the other phases
// reuse the same bytes
template <typename T>
struct GemvSmem {
  static constexpr size_t kA = static_cast<size_t>(kRows) * kLdA * sizeof(T);
  static constexpr size_t kW = static_cast<size_t>(kStages) * kTileK * kLdW * sizeof(T);
  static constexpr size_t kRed = 2 * kRows * kStrip * sizeof(float);
  static constexpr size_t kStats = 2 * kRows * sizeof(float);
  static constexpr size_t kBytes = kA + kW + kRed + kStats;
};

template <typename T, typename KV>
struct Params {
  const T* x;
  const T* ln1_w;
  const T* ln1_b;
  const T* w_qkv;
  const T* b_qkv;
  const T* w_out;
  const T* b_out;
  const T* ln2_w;
  const T* ln2_b;
  const T* w_up;
  const T* b_up;
  const T* w_down;
  const T* b_down;
  const KV* k;
  const KV* v;
  const float* ks;     // int8 only
  const float* vs;
  const int* tables;   // paged only: [B, MB]
  const int* lengths;  // [B], tokens cached before the new one
  T* x_out;            // [B, H]
  T* k_new;            // [B, Hkv, D]
  T* v_new;
  float* scratch;
  int B, H, Hkv, F, cap, bs, MB;
  int ks_qkv, ks_out, ks_up, ks_down;  // input-dimension chunks of each product
  float eps, scale;
};

// scratch offsets in floats: partial sums of each product ([chunks][B][N]),
// the attention output and LN2's output (both in T), x2 in f32
struct Layout {
  long qkv, attn, out, x2, h2, up, down, total;
  __host__ __device__ Layout(int B, int H, int Nq, int F, int kq, int ko, int ku, int kd) {
    qkv = 0;
    attn = qkv + static_cast<long>(kq) * B * Nq;
    out = attn + static_cast<long>(B) * H;
    x2 = out + static_cast<long>(ko) * B * H;
    h2 = x2 + static_cast<long>(B) * H;
    up = h2 + static_cast<long>(B) * H;
    down = up + static_cast<long>(ku) * B * F;
    total = down + static_cast<long>(kd) * B * H;
  }
};

enum class Fill { kLn1, kCopy, kGelu };

// One product phase: part[c][b][n] = sum over input rows k of chunk c of
// A[b][k] * W[k][n], for every 64-column strip and chunk; A is built in
// shared memory per item by `fill`.
template <typename T, typename KV, Fill kFill>
__device__ __forceinline__ void gemv_phase(const Params<T, KV>& p, unsigned char* smem, const T* W,
                                           int K, int N, int chunks, float* part,
                                           const T* src_t, const float* up_part, int up_chunks,
                                           const T* bias, const float* mu, const float* rstd) {
  using flash::Mma;
  T* sA = reinterpret_cast<T*>(smem);
  T* sW = reinterpret_cast<T*>(smem + GemvSmem<T>::kA);
  float* red = reinterpret_cast<float*>(smem + GemvSmem<T>::kA + GemvSmem<T>::kW);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ntile = warp & 7;
  const int khalf = warp >> 3;
  const int kc = K / chunks;
  const int strips = N / kStrip;
  const int items = strips * chunks;
  const int B = p.B;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int chunk = it / strips;
    const int n0 = (it % strips) * kStrip;
    const int k0 = chunk * kc;
    const int nkt = kc / kTileK;
    __syncthreads();  // the previous item is done with every buffer

    auto load_tile = [&](int t) {
      // 64 rows x 64 columns: one 16-byte copy per thread
      const int r = threadIdx.x >> 3;
      const int c = (threadIdx.x & 7) * 8;
      cp_async16(sW + ((t % kStages) * kTileK + r) * kLdW + c,
                 W + static_cast<long>(k0 + t * kTileK + r) * N + n0 + c);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nkt) load_tile(s);
      cp_async_commit();
    }

    // the activation chunk, rows past B zero
    for (int i = threadIdx.x; i < kRows * kc; i += kThreads) {
      const int b = i / kc;
      const int k = i - b * kc;
      float val = 0.f;
      if (b < B) {
        const int kk = k0 + k;
        if constexpr (kFill == Fill::kLn1) {
          val = (to_f(p.x[static_cast<long>(b) * K + kk]) - mu[b]) * rstd[b];
          val = val * to_f(p.ln1_w[kk]) + to_f(p.ln1_b[kk]);
        } else if constexpr (kFill == Fill::kCopy) {
          val = to_f(src_t[static_cast<long>(b) * K + kk]);
        } else {
          float u = 0.f;
          for (int c = 0; c < up_chunks; ++c) u += up_part[(static_cast<long>(c) * B + b) * K + kk];
          val = gelu_tanh(u + to_f(bias[kk]));
        }
      }
      sA[b * kLdA + k] = decode_attn::from_float<T>(val);
    }

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < nkt; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile t landed (and the activation chunk is written)
      if (t + kStages - 1 < nkt) load_tile(t + kStages - 1);
      cp_async_commit();
      const T* tile = sW + (t % kStages) * kTileK * kLdW;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kk = (khalf * 2 + j) * 16;
        uint32_t a[4], b[2];
        flash::load_a(a, sA, kLdA, 0, t * kTileK + kk, gid, tig);
        flash::load_b_cols(b, tile, kLdW, kk, ntile * 8, gid, tig);
        Mma<T>::run(acc, a, b);
      }
    }
    cp_async_wait<0>();
    // the two halves of each 64-row tile meet in shared memory
    float* r = red + khalf * kRows * kStrip;
    r[gid * kStrip + ntile * 8 + tig * 2] = acc[0];
    r[gid * kStrip + ntile * 8 + tig * 2 + 1] = acc[1];
    r[(gid + 8) * kStrip + ntile * 8 + tig * 2] = acc[2];
    r[(gid + 8) * kStrip + ntile * 8 + tig * 2 + 1] = acc[3];
    __syncthreads();
    for (int i = threadIdx.x; i < B * kStrip; i += kThreads) {
      const int b = i / kStrip;
      const int n = i - b * kStrip;
      part[(static_cast<long>(chunk) * B + b) * N + n0 + n] = red[b * kStrip + n] + red[kRows * kStrip + i];
    }
  }
}

// sum over chunks of a product's partials, then its bias (f32)
__device__ __forceinline__ float sum_parts(const float* part, int chunks, int B, int N, int b, int n) {
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(static_cast<long>(c) * B + b) * N + n];
  return s;
}

// Block-wide sum over 512 threads; `buf` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += buf[w];
  return s;
}

// Phase 2: one (slot, kv head) item.  The kv head's query group is taken
// one head at a time (the slot's positions stream once per head): the
// serving shapes are MHA.
template <typename T, typename KV, int D, bool kPaged>
__device__ __forceinline__ void attend_item(const Params<T, KV>& p, unsigned char* smem, int b, int hk,
                                            const float* part_qkv, T* attn) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kVec = decode_attn::Vec<KV>::kN;
  constexpr int kLanesPerPos = D / kVec;
  constexpr int kPosPerWarp = 32 / kLanesPerPos;
  constexpr int kSlots = kWarps * kPosPerWarp;
  constexpr int kUnroll = 2;
  float* s_q = reinterpret_cast<float*>(smem);  // [D]
  float* s_kn = s_q + D;                         // [D] the new key as attended
  float* s_vn = s_kn + D;                        // [D]
  float* s_m = s_vn + D;                         // [kSlots]
  float* s_l = s_m + kSlots;                     // [kSlots]
  float* s_acc = s_l + kSlots;                   // [kWarps][D]
  float* s_red = s_acc + kWarps * D;             // [kWarps + 2]

  const int H = p.H;
  const int G = H / (p.Hkv * D);
  const int Nq = H + 2 * p.Hkv * D;
  const int kvd = p.Hkv * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerPos;
  const int dl = lane % kLanesPerPos;
  const int slot = warp * kPosPerWarp + grp;
  const int len = max(p.lengths[b], 0);
  const int L = kPaged ? min(len, p.MB * p.bs) : min(len, p.cap - 1);

  __syncthreads();  // the previous item is done with shared memory
  // the new token's k and v: raw out to the caller, as attended in smem
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const int ck = H + hk * D + d;
    const int cv = H + kvd + hk * D + d;
    const float kn = sum_parts(part_qkv, p.ks_qkv, p.B, Nq, b, ck) + to_f(p.b_qkv[ck]);
    const float vn = sum_parts(part_qkv, p.ks_qkv, p.B, Nq, b, cv) + to_f(p.b_qkv[cv]);
    const long o = (static_cast<long>(b) * p.Hkv + hk) * D + d;
    p.k_new[o] = decode_attn::from_float<T>(kn);
    p.v_new[o] = decode_attn::from_float<T>(vn);
    s_kn[d] = kn;
    s_vn[d] = vn;
  }
  __syncthreads();
  if constexpr (kQuant) {
    // the composed path stores the new k/v as int8 and attends the codes:
    // the same round trip (amax / 127 scale, round half to even, clip)
    if (warp < 2) {
      float* vec = warp == 0 ? s_kn : s_vn;
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(vec[d]));
      amax = warp_max(amax);
      const float sc = fmaxf(amax, 1e-8f) / 127.f;
      for (int d = lane; d < D; d += 32) vec[d] = fminf(fmaxf(rintf(vec[d] / sc), -127.f), 127.f) * sc;
    }
    __syncthreads();
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int d = threadIdx.x; d < D; d += kThreads)
      s_q[d] = sum_parts(part_qkv, p.ks_qkv, p.B, Nq, b, h * D + d) + to_f(p.b_qkv[h * D + d]);
    __syncthreads();
    float qv[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) qv[e] = s_q[dl * kVec + e];
    float m = kNeg, l = 0.f, acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

    for (int base = warp * kPosPerWarp; base < L; base += kSlots * kUnroll) {
      uint4 kr[kUnroll], vr[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + grp + u * kSlots;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        ksc[u] = vsc[u] = 0.f;
        if (j < L) {
          long row;
          if constexpr (kPaged) {
            const int bi = j / p.bs;
            row = static_cast<long>(p.tables[static_cast<long>(b) * p.MB + bi]) * p.bs + (j - bi * p.bs);
          } else {
            row = static_cast<long>(b) * p.cap + j;
          }
          const long r = row * p.Hkv + hk;
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
        const bool valid = base + grp + u * kSlots < L;
        float kf[kVec], vf[kVec];
        decode_attn::Vec<KV>::to_float(kr[u], kf);
        decode_attn::Vec<KV>::to_float(vr[u], vf);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qv[e], kf[e], part);
#pragma unroll
        for (int off = 1; off < kLanesPerPos; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if constexpr (kQuant) part *= ksc[u];
        part *= p.scale;
        if (valid) {
          const float mn = fmaxf(m, part);
          const float alpha = __expf(m - mn);
          const float pr = __expf(part - mn);
          const float pv = kQuant ? pr * vsc[u] : pr;
          l = l * alpha + pr;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(acc[e], alpha, pv * vf[e]);
          m = mn;
        }
      }
    }

    // merge the position slots in a fixed order
    if (dl == 0) {
      s_m[slot] = m;
      s_l[slot] = l;
    }
    // the new token's score q . k_new (unscaled sum in warp 0)
    if (warp == 0) {
      float sdot = 0.f;
      for (int d = lane; d < D; d += 32) sdot = fmaf(s_q[d], s_kn[d], sdot);
      sdot = warp_sum(sdot);
      if (lane == 0) s_red[0] = sdot * p.scale;
    }
    __syncthreads();
    float mx = kNeg;
    for (int s = 0; s < kSlots; ++s) mx = fmaxf(mx, s_m[s]);
    const float f = __expf(m - mx);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float a = acc[e] * f;
#pragma unroll
      for (int off = kLanesPerPos; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[e] = a;
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) s_acc[warp * D + dl * kVec + e] = acc[e];
    }
    __syncthreads();
    const float s_new = s_red[0];
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float denom = 0.f;
      for (int s = 0; s < kSlots; ++s) denom += s_l[s] * __expf(s_m[s] - mx);
      float num = 0.f;
      for (int w = 0; w < kWarps; ++w) num += s_acc[w * D + d];
      // fold the new token last: m, l and acc rescaled to the new maximum
      const float m_new = fmaxf(mx, s_new);
      const float alpha = expf(mx - m_new);
      const float pnew = expf(s_new - m_new);
      const float l_new = denom * alpha + pnew;
      const float o = (num * alpha + pnew * s_vn[d]) / fmaxf(l_new, 1e-30f);
      attn[static_cast<long>(b) * H + h * D + d] = decode_attn::from_float<T>(o);
    }
    __syncthreads();  // s_q, s_m, s_acc are rewritten by the next head
  }
}

template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads) mega_kernel(const Params<T, KV> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, H = p.H, F = p.F;
  const int Nq = H + 2 * p.Hkv * D;
  const Layout lay(B, H, Nq, F, p.ks_qkv, p.ks_out, p.ks_up, p.ks_down);
  float* part_qkv = p.scratch + lay.qkv;
  T* attn = reinterpret_cast<T*>(p.scratch + lay.attn);
  float* part_out = p.scratch + lay.out;
  float* x2 = p.scratch + lay.x2;
  T* h2 = reinterpret_cast<T*>(p.scratch + lay.h2);
  float* part_up = p.scratch + lay.up;
  float* part_down = p.scratch + lay.down;
  float* stats = reinterpret_cast<float*>(smem + GemvSmem<T>::kA + GemvSmem<T>::kW + GemvSmem<T>::kRed);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // 1: LN1 row statistics (every block, one warp a slot), then qkv
  if (warp < B) {
    const T* xr = p.x + static_cast<long>(warp) * H;
    float s = 0.f;
    for (int i = lane; i < H; i += 32) s += to_f(xr[i]);
    const float mu = warp_sum(s) / H;
    float v = 0.f;
    for (int i = lane; i < H; i += 32) {
      const float d = to_f(xr[i]) - mu;
      v = fmaf(d, d, v);
    }
    const float var = warp_sum(v) / H;
    if (lane == 0) {
      stats[warp] = mu;
      stats[kRows + warp] = rsqrtf(var + p.eps);
    }
  }
  __syncthreads();
  gemv_phase<T, KV, Fill::kLn1>(p, smem, p.w_qkv, H, Nq, p.ks_qkv, part_qkv, nullptr, nullptr, 0,
                                nullptr, stats, stats + kRows);
  grid.sync();

  // 2: attention, (slot, kv head) items
  for (int it = blockIdx.x; it < B * p.Hkv; it += gridDim.x)
    attend_item<T, KV, D, kPaged>(p, smem, it / p.Hkv, it % p.Hkv, part_qkv, attn);
  grid.sync();

  // 3: out projection
  gemv_phase<T, KV, Fill::kCopy>(p, smem, p.w_out, H, H, p.ks_out, part_out, attn, nullptr, 0,
                                 nullptr, nullptr, nullptr);
  grid.sync();

  // 4: x2 = x + (o + b_out), LN2, one slot per block
  {
    float* row = reinterpret_cast<float*>(smem);  // [H]
    float* buf = row + H;                         // [kWarps]
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      __syncthreads();
      float s = 0.f;
      for (int n = threadIdx.x; n < H; n += kThreads) {
        const float o = sum_parts(part_out, p.ks_out, B, H, b, n) + to_f(p.b_out[n]);
        const float v = to_f(p.x[static_cast<long>(b) * H + n]) + o;
        row[n] = v;
        x2[static_cast<long>(b) * H + n] = v;
        s += v;
      }
      const float mu = block_sum(s, buf) / H;
      float q = 0.f;
      for (int n = threadIdx.x; n < H; n += kThreads) {
        const float d = row[n] - mu;
        q = fmaf(d, d, q);
      }
      const float rstd = rsqrtf(block_sum(q, buf) / H + p.eps);
      for (int n = threadIdx.x; n < H; n += kThreads) {
        const float v = (row[n] - mu) * rstd * to_f(p.ln2_w[n]) + to_f(p.ln2_b[n]);
        h2[static_cast<long>(b) * H + n] = decode_attn::from_float<T>(v);
      }
    }
  }
  grid.sync();

  // 5: up projection
  gemv_phase<T, KV, Fill::kCopy>(p, smem, p.w_up, H, F, p.ks_up, part_up, h2, nullptr, 0, nullptr,
                                 nullptr, nullptr);
  grid.sync();

  // 6: down projection over gelu(u + b_up)
  gemv_phase<T, KV, Fill::kGelu>(p, smem, p.w_down, F, H, p.ks_down, part_down, nullptr, part_up,
                                 p.ks_up, p.b_up, nullptr, nullptr);
  grid.sync();

  // 7: x_out = (x2 + mlp) + b_down
  const long total = static_cast<long>(B) * H;
  for (long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long>(gridDim.x) * kThreads) {
    const int b = static_cast<int>(i / H);
    const int n = static_cast<int>(i - static_cast<long>(b) * H);
    const float v = (x2[i] + sum_parts(part_down, p.ks_down, B, H, b, n)) + to_f(p.b_down[n]);
    p.x_out[i] = decode_attn::from_float<T>(v);
  }
}

// What the C entry points pass: pointers in LAYER_WEIGHTS order after x,
// then the cache, tables, lengths, outputs and scratch; sizes.
struct Args {
  const void* ptr[23];
  int B, H, Hkv, D, F, cap, bs, MB;
  int ks_qkv, ks_out, ks_up, ks_down;
  int dtype;  // of x, the weights and the outputs: 0 = bf16, 1 = fp16
  float eps;
  void* stream;
};

template <typename T, typename KV, int D, bool kPaged>
int launch(const Args& a) {
  constexpr size_t kSmem = GemvSmem<T>::kBytes;
  auto kernel = mega_kernel<T, KV, D, kPaged>;
  static int grid = 0;  // co-resident blocks, once per template instance
  if (grid == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid = per_sm * sms;
  }
  Params<T, KV> p;
  const void* const* q = a.ptr;
  p.x = static_cast<const T*>(q[0]);
  p.ln1_w = static_cast<const T*>(q[1]);
  p.ln1_b = static_cast<const T*>(q[2]);
  p.w_qkv = static_cast<const T*>(q[3]);
  p.b_qkv = static_cast<const T*>(q[4]);
  p.w_out = static_cast<const T*>(q[5]);
  p.b_out = static_cast<const T*>(q[6]);
  p.ln2_w = static_cast<const T*>(q[7]);
  p.ln2_b = static_cast<const T*>(q[8]);
  p.w_up = static_cast<const T*>(q[9]);
  p.b_up = static_cast<const T*>(q[10]);
  p.w_down = static_cast<const T*>(q[11]);
  p.b_down = static_cast<const T*>(q[12]);
  p.k = static_cast<const KV*>(q[13]);
  p.v = static_cast<const KV*>(q[14]);
  p.ks = static_cast<const float*>(q[15]);
  p.vs = static_cast<const float*>(q[16]);
  p.tables = static_cast<const int*>(q[17]);
  p.lengths = static_cast<const int*>(q[18]);
  p.x_out = static_cast<T*>(const_cast<void*>(q[19]));
  p.k_new = static_cast<T*>(const_cast<void*>(q[20]));
  p.v_new = static_cast<T*>(const_cast<void*>(q[21]));
  p.scratch = static_cast<float*>(const_cast<void*>(q[22]));
  p.B = a.B;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.F = a.F;
  p.cap = a.cap;
  p.bs = a.bs;
  p.MB = a.MB;
  p.ks_qkv = a.ks_qkv;
  p.ks_out = a.ks_out;
  p.ks_up = a.ks_up;
  p.ks_down = a.ks_down;
  p.eps = a.eps;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                                      dim3(kThreads), args, kSmem,
                                                      static_cast<cudaStream_t>(a.stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// a product's input-dimension chunking: K / chunks a multiple of 64, at
// most kMaxChunk
inline bool chunks_ok(int K, int chunks) {
  return chunks >= 1 && K % chunks == 0 && (K / chunks) % kTileK == 0 && K / chunks <= kMaxChunk;
}

// The entry points' dispatch.  Returns a cudaError_t.
template <bool kQuant, bool kPaged>
int run(const Args& a) {
  if (a.B < 1 || a.B > kRows || a.Hkv < 1 || a.H % 128 != 0 || a.F % 128 != 0 ||
      a.H % (a.Hkv * a.D) != 0 || (a.D != 64 && a.D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Nq = a.H + 2 * a.Hkv * a.D;
  if (!chunks_ok(a.H, a.ks_qkv) || !chunks_ok(a.H, a.ks_out) || !chunks_ok(a.H, a.ks_up) ||
      !chunks_ok(a.F, a.ks_down) || Nq % kStrip != 0 ||
      (a.H + kWarps) * 4 > kRows * kLdA * 2)  // LN2's f32 row fits the activation buffer
    return static_cast<int>(cudaErrorInvalidValue);
  if (kPaged ? (a.bs < 1 || a.MB < 1) : a.cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  using BF = __nv_bfloat16;
  using FH = __half;
  using KB = typename std::conditional<kQuant, int8_t, BF>::type;
  using KH = typename std::conditional<kQuant, int8_t, FH>::type;
  if (a.dtype == 0 && a.D == 128) return launch<BF, KB, 128, kPaged>(a);
  if (a.dtype == 0 && a.D == 64) return launch<BF, KB, 64, kPaged>(a);
  if (a.dtype == 1 && a.D == 128) return launch<FH, KH, 128, kPaged>(a);
  if (a.dtype == 1 && a.D == 64) return launch<FH, KH, 64, kPaged>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mega
