// Flash-attention backward, dq (and delta), for Hopper (sm_90a): bf16 or
// fp16 inputs, f32 accumulation.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_bwd_dq_kernel (launched by
// _bwd_gqa), and the delta rowsum _bwd_gqa forms before it.  Same math:
// delta = rowsum(do * o) in f32 from the saved o; with p = exp(scale *
// q k^T - lse) recomputed from the forward's per-row lse (0 where the
// score is masked: the `s <= -1e30 / 2` rule, so a fully masked row gives
// p = 0 rather than exp(-1e30 + 1e30) = 1), dp = do v^T, ds = p * (dp -
// delta) rounded to the input dtype, dq = scale * ds k.  Causal or full,
// an optional key mask [B, S] (1 = attend), GQA native (query head
// h = hk * G + g reads kv head hk), any S (rows and keys past S are
// masked here).  delta [B, H, S] is written out for the dk/dv kernel.
//
// What bounds it: three products of 2 * S * Sk * D FLOPs per head (q k^T,
// do v^T, ds k; halved under causal) against O(S * D) bytes, so the
// tensor cores bound it at training shapes (S = 2048, D = 128: ~500 FLOP
// per byte).  The design (hopper_tile.cuh):
// - one block = one 192-row q tile of one (batch, head): a producer
//   warpgroup, of which one warp loads, and three consumer warpgroups of
//   64 rows each (setmaxnreg moves registers from the producer to the
//   consumers; a third consumer hides more of each one's softmax and
//   wgmma waits than two with more registers would: flash_bwd_variants.py
//   times the two);
// - q and do stay resident in shared memory; K/V tiles of 64 keys stream
//   through a three-stage TMA ring with full/empty mbarriers, 128-byte
//   swizzle, and the producer warp's lanes copy the key mask's 64 values
//   (0 past S) into the same stage;
// - s = q k^T and dp = do v^T are wgmma with both operands in shared
//   memory (k and v K-major as stored); ds stays in registers and is the
//   A operand of dq += ds k, which reads the same k tile MN-major
//   through the transpose bit: p and ds never leave registers.  (q and do
//   held as register A operands across the key loop gave wrong dq at
//   D = 64: register operands of an asynchronous wgmma are not kept
//   safe across loop iterations);
// - p = 2^(s log2 e - lse log2 e) on the special-function unit, with the
//   masking skipped on tiles below the diagonal that hold S keys;
// - the prologue forms delta from the do tile already in shared memory
//   and o read once from device memory;
// - under causal, blocks of the last q tiles (the longest key loops) are
//   launched first, and each key loop stops at the diagonal.
// No atomics: each block writes its own dq and delta rows, so results are
// deterministic.
// Attention dropout (flash_bwd_dq_dropout): the same kernel with kDrop
// redraws the forward's keep bits z (philox.cuh) for its tile before
// waiting for it, and ds = p * (z * dp / (1 - p) - delta), delta from the
// dropped o the forward saved.
#include <type_traits>

#include "hopper_tile.cuh"
#include "philox.cuh"

namespace {

using hopper::Wgmma;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 3;  // consumer warpgroups of 64 q rows each
constexpr int kBlockQ = 64 * kConsumers;
constexpr int kBlockK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);  // + the producer
// registers a thread after setmaxnreg: the consumers take what the
// producer warpgroup gives up (at most 64 K a block)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "register file");

// byte offsets from the 1024-aligned base of dynamic shared memory
template <int D>
struct Smem {
  static constexpr int kTileQ = kBlockQ * D * 2;
  static constexpr int kTileK = kBlockK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTileQ;
  static constexpr int kRing = kDO + kTileQ;  // stage s: K, then V
  static constexpr int kStage = 2 * kTileK;
  static constexpr int kMask = kRing + kStages * kStage;  // 64 f32 a stage
  static constexpr int kDelta = kMask + kStages * kBlockK * 4;
  static constexpr int kBars = kDelta + kBlockQ * 4;  // q/do, full, empty
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
};

template <typename T>
__device__ __forceinline__ float2 to_f2(uint32_t x);

template <>
__device__ __forceinline__ float2 to_f2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

template <>
__device__ __forceinline__ float2 to_f2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// sum of the eight products of two 16-byte vectors of T, in f32
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = to_f2<T>(x[i]), w = to_f2<T>(y[i]);
    s += u.x * w.x + u.y * w.y;
  }
  return s;
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ kv_mask,
                        const T* __restrict__ o, const float* __restrict__ lse,
                        T* __restrict__ dq, float* __restrict__ delta, int B,
                        int S, int H, int Hkv, int causal, float scale,
                        const int64_t* __restrict__ philox, uint32_t drop_thr,
                        float drop_scale) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  auto full = [&](int s) { return base + L::kBars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::kBars + 8 * (1 + kStages + s); };
  auto ring = [&](int s) { return base + L::kRing + s * L::kStage; };

  // longest first: under causal the last q tiles have the most keys
  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x % (B * H);
  int qt = blockIdx.x / (B * H);
  if (causal) qt = n_qt - 1 - qt;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBlockQ;
  int n_kt = (S + kBlockK - 1) / kBlockK;
  if (causal) n_kt = min(n_kt, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 32);  // the producer warp's lanes
      hopper::mbar_init(empty(s), 4 * kConsumers);  // each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warp: lane 0 issues every TMA load; lanes 1-31 copy
    // the key mask's 64 values of each stage ----
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_expect_tx(bar_q, 2 * L::kTileQ);
        hopper::tma_load_rows<D>(base + L::kQ, &tm_q, bar_q, kBlockQ, b, h,
                                 q0);
        hopper::tma_load_rows<D>(base + L::kDO, &tm_do, bar_q, kBlockQ, b,
                                 h, q0);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        const int k0 = kt * kBlockK;
        if (lane == 0) {
          hopper::mbar_expect_tx(full(s), L::kStage);
          hopper::tma_load_rows<D>(ring(s), &tm_k, full(s), kBlockK, b, hk,
                                   k0);
          hopper::tma_load_rows<D>(ring(s) + L::kTileK, &tm_v, full(s),
                                   kBlockK, b, hk, k0);
        }
        if (lane != 0) {  // lane 0's arrival came with its expect_tx
          float* s_mask = reinterpret_cast<float*>(gbase + L::kMask +
                                                   s * kBlockK * 4);
          for (int j = lane - 1; j < kBlockK; j += 31) {
            const int key = k0 + j;
            s_mask[j] = key >= S ? 0.f
                        : kv_mask ? kv_mask[static_cast<long>(b) * S + key]
                                  : 1.f;
          }
          hopper::mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns q rows [64 c, 64 c + 64) ----
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const long q_stride = static_cast<long>(H) * D;
    const long q_off =
        static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    const long row_off = (static_cast<long>(b) * H + h) * S;
    float* s_delta = reinterpret_cast<float*>(gbase + L::kDelta);

    hopper::mbar_wait(bar_q, 0);
    // delta = rowsum(do * o) in f32: two threads a row, each half of D;
    // do from the swizzled tile, o from device memory
    {
      const int r = c * 64 + (t >> 1);
      const int part = t & 1;
      const int qi = q0 + r;
      float acc = 0.f;
      if (qi < S) {
        const T* orow = o + q_off + qi * q_stride;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          const int ch = part * (D / 16) + j;  // 16-byte chunk of the row
          const uint4 dv = *reinterpret_cast<const uint4*>(
              gbase + L::kDO + (ch / 8) * kBlockQ * 128 + r * 128 +
              (((ch % 8) ^ (r & 7)) * 16));
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + ch * 8);
          acc += dot8<T>(dv, ov);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (part == 0) {
        s_delta[r] = acc;
        if (qi < S) delta[row_off + qi] = acc;
      }
    }
    hopper::named_sync(1 + c, 128);

    // this thread's rows: r0 (accumulator elements 0, 1) and r0 + 8 (2, 3)
    const int r0 = c * 64 + warp * 16 + gid;
    const int qi[2] = {q0 + r0, q0 + r0 + 8};
    const float scale_l2 = scale * kLog2e;
    float lse_l2[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_l2[r] = qi[r] < S ? lse[row_off + qi[r]] * kLog2e : 0.f;
      dl_r[r] = s_delta[r0 + 8 * r];
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t a_q = base + L::kQ + c * 64 * 128;
    const uint32_t a_do = base + L::kDO + c * 64 * 128;
    const int first_row = q0 + c * 64;
    const int last_row = first_row + 63;
    const philox::MaybeDropout<kDrop> drop(philox, b * H + h, drop_thr);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const int k0 = kt * kBlockK;
      // the tile's keep bits (bit i: accumulator element i), drawn while
      // its loads are in flight
      uint32_t keep = 0u;
      if constexpr (kDrop) {
        if (!(causal && k0 > last_row)) {
#pragma unroll
          for (int g2 = 0; g2 < kBlockK / 16; ++g2)
            keep |= drop.row_bits(drop.call(qi[0], k0 + 16 * g2 + 2 * tig))
                    << (8 * g2);
        }
      }
      hopper::mbar_wait(full(s), (kt / kStages) & 1);
      // a tile above the diagonal for every row of this warpgroup is skipped
      if (!(causal && k0 > last_row)) {
        const uint32_t sk = ring(s);
        const uint32_t sv = sk + L::kTileK;
        float st[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          Wgmma<T, 64, 0>::ss(
              st, hopper::desc_sw128(a_q + (j / 4) * kBlockQ * 128 + (j % 4) * 32, 16, 1024),
              hopper::desc_sw128(sk + (j / 4) * kBlockK * 128 + (j % 4) * 32,
                                 16, 1024),
              j > 0);
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          Wgmma<T, 64, 0>::ss(
              dp, hopper::desc_sw128(a_do + (j / 4) * kBlockQ * 128 + (j % 4) * 32, 16, 1024),
              hopper::desc_sw128(sv + (j / 4) * kBlockK * 128 + (j % 4) * 32,
                                 16, 1024),
              j > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<32>(st);
        hopper::fence_regs<32>(dp);

        // ds = p * (dp - delta), p recomputed from lse as 2^(s log2 e -
        // lse log2 e); masked scores give 0.  Tiles below the diagonal
        // with every key in range and no key mask skip the masking.
        if (!kv_mask && k0 + kBlockK <= S &&
            (!causal || k0 + kBlockK - 1 <= first_row)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = (i >> 1) & 1;
            const float p = hopper::ex2(fmaf(st[i], scale_l2, -lse_l2[row]));
            float dpi = dp[i];
            if constexpr (kDrop) dpi = (keep >> i) & 1u ? dpi * drop_scale : 0.f;
            st[i] = p * (dpi - dl_r[row]);
          }
        } else {
          const float* s_mask = reinterpret_cast<const float*>(
              gbase + L::kMask + s * kBlockK * 4);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = (i / 4) * 8 + tig * 2 + (i & 1);
            const int row = (i >> 1) & 1;
            const bool ok =
                s_mask[col] > 0.f && (!causal || k0 + col <= qi[row]);
            const float sc = ok ? st[i] * scale_l2 : kNeg;
            const float p =
                sc <= 0.5f * kNeg ? 0.f : hopper::ex2(sc - lse_l2[row]);
            float dpi = dp[i];
            if constexpr (kDrop) dpi = (keep >> i) & 1u ? dpi * drop_scale : 0.f;
            st[i] = p * (dpi - dl_r[row]);
          }
        }
        uint32_t dsa[4][4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) hopper::pack_a<T>(dsa[cc], st, cc);

        // dq += ds (64 rows x 64 keys) . k (64 keys x D), k read MN-major
        hopper::wgmma_fence();
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          Wgmma<T, D, 1>::rs(
              acc, dsa[cc],
              hopper::desc_sw128(sk + cc * 16 * 128, kBlockK * 128, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<D / 2>(acc);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // epilogue: dq = scale * acc, written in the input dtype
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= S) continue;
      T* row = dq + q_off + qi[r] * q_stride;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + tig * 2) = hopper::pack2<T>(
            acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

template <typename T, int D, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* kv_mask, void* dq,
           void* delta, int B, int S, int H, int Hkv, int causal,
           const void* philox, int drop_thr, float drop_scale,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes + 1024;  // + alignment slack
  // above the 48 KB default: raised once per instantiation (on the device
  // current at the first launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool fp16 = std::is_same<T, __half>::value;
  // tensor maps hold the data pointers: encoded on every call
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::map_bshd(&tq, q, fp16, B, S, H, D, kBlockQ) ||
      !hopper::map_bshd(&tdo, dout, fp16, B, S, H, D, kBlockQ) ||
      !hopper::map_bshd(&tk, k, fp16, B, S, Hkv, D, kBlockK) ||
      !hopper::map_bshd(&tv, v, fp16, B, S, Hkv, D, kBlockK))
    return static_cast<int>(cudaErrorNotSupported);
  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  flash_bwd_dq_kernel<T, D, kDrop><<<n_qt * B * H, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(kv_mask),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), B, S, H, Hkv, causal,
      1.f / sqrtf(static_cast<float>(D)), static_cast<const int64_t*>(philox),
      static_cast<uint32_t>(drop_thr), drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDrop>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, const void* kv_mask, void* dq,
             void* delta, int B, int S, int H, int Hkv, int D, int causal,
             int dtype, const void* philox, int drop_thr, float drop_scale,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128, kDrop>(q, k, v, o, dout, lse, kv_mask, dq, delta, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64, kDrop>(q, k, v, o, dout, lse, kv_mask, dq, delta, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 1 && D == 128)
    return launch<__half, 128, kDrop>(q, k, v, o, dout, lse, kv_mask, dq, delta, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 1 && D == 64)
    return launch<__half, 64, kDrop>(q, k, v, o, dout, lse, kv_mask, dq, delta, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q / o / dout / dq [B, S, H, D], k/v [B, S, Hkv, D], lse [B, H, S] f32
// in, delta [B, H, S] f32 out, kv_mask [B, S] f32 or null, all contiguous
// and 16-byte aligned.  dtype: 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            const void* kv_mask, void* dq, void* delta, int B,
                            int S, int H, int Hkv, int D, int causal,
                            int dtype, void* stream) {
  return dispatch<false>(q, k, v, o, dout, lse, kv_mask, dq, delta, B, S, H,
                         Hkv, D, causal, dtype, nullptr, 0, 1.f, stream);
}

// flash_bwd_dq with attention dropout: o is the forward's dropped output;
// philox, drop_thr and drop_scale as the forward's flash_fwd_dropout got
// them, so the keep bits are the forward's.
extern "C" int flash_bwd_dq_dropout(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    const void* kv_mask, void* dq,
                                    void* delta, int B, int S, int H, int Hkv,
                                    int D, int causal, int dtype,
                                    const void* philox, int drop_thr,
                                    float drop_scale, void* stream) {
  if (!philox || drop_thr < 0 || drop_thr > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, o, dout, lse, kv_mask, dq, delta, B, S, H,
                        Hkv, D, causal, dtype, philox, drop_thr, drop_scale,
                        stream);
}
