// Flash-attention backward, dk and dv, for Hopper (sm_90a): bf16 or fp16
// inputs, f32 accumulation.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_bwd_dkv_kernel (launched by
// _bwd_gqa).  Same math, per key j: dv_j = sum_i p_ij do_i with p rounded
// to the input dtype, dk_j = scale * sum_i ds_ij q_i with ds = p * (dp -
// delta) rounded likewise, p = exp(scale * q k^T - lse) recomputed from the
// forward's lse (0 where the score is masked), dp = do v^T, delta =
// rowsum(do * o) as the dq kernel wrote it.  Both sums also run over the
// G query heads of the kv head's group.  Causal or full, an optional key
// mask [B, S], any S (rows and keys past S are masked here).
//
// What bounds it: four products of 2 * S * Sk * D FLOPs per head (k q^T,
// v do^T, p^T do, ds^T q; halved under causal) against O(S * D) bytes, so
// the tensor cores bound it at training shapes.  The design
// (hopper_tile.cuh):
// - one block = one 128-key tile of one (batch, kv head): a producer
//   warpgroup, of which one warp loads, and two consumer
//   warpgroups of 64 keys each; dk and dv of 64 keys x D = 128 are 128
//   f32 registers a thread, so setmaxnreg gives the consumers 240;
// - k and v stay resident in shared memory; Q/dO tiles of 64 queries
//   stream through a three-stage TMA ring (full/empty mbarriers, 128-byte
//   swizzle), the producer warp's lanes copying their 64 lse and delta
//   values into the same stage, over every query tile of
//   every query head of the group: the TPU kernel's sequential grid
//   dimension g becomes this loop, so dk/dv need no atomics and no second
//   pass, and results are deterministic;
// - s^T = k q^T and dp^T = v do^T are wgmma with both operands in shared
//   memory; p^T and ds^T stay in registers as the A operands of dv +=
//   p^T do and dk += ds^T q, which read the same q and do tiles MN-major
//   through the transpose bit;
// - p = 2^(s log2 e - lse log2 e) on the special-function unit (the
//   producer scales lse by log2 e), with the masking skipped on tiles
//   below the diagonal that hold S keys and queries and no key mask;
// - under causal, blocks of the first key tiles (the longest query loops)
//   are launched first, and each query loop starts at the diagonal.
// Attention dropout (flash_bwd_dkv_dropout): the same kernel with kDrop
// redraws the forward's keep bits z for each query tile of each query
// head of the group (philox.cuh: the accumulator's rows are keys here, so
// a thread and the lane four away draw one call each and swap half of
// it), then dv += (z * p / (1 - p))^T do and ds = p * (z * dp / (1 - p) -
// delta).
#include <type_traits>

#include "hopper_tile.cuh"
#include "philox.cuh"

namespace {

using hopper::Wgmma;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockK = 128;  // two consumer warpgroups x 64 keys
constexpr int kBlockQ = 64;
constexpr int kStages = 3;
constexpr int kThreads = 384;  // producer warpgroup + two consumers

// byte offsets from the 1024-aligned base of dynamic shared memory
template <int D>
struct Smem {
  static constexpr int kTileK = kBlockK * D * 2;
  static constexpr int kTileQ = kBlockQ * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileK;
  static constexpr int kRing = kV + kTileK;  // stage s: Q, then dO
  static constexpr int kStage = 2 * kTileQ;
  static constexpr int kRows = kRing + kStages * kStage;  // lse, delta
  static constexpr int kRowStage = 2 * kBlockQ * 4;
  static constexpr int kBars = kRows + kStages * kRowStage;  // k/v, full, empty
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
};

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kv_mask,
                         T* __restrict__ dk, T* __restrict__ dv, int B, int S,
                         int H, int Hkv, int causal, float scale,
                         const int64_t* __restrict__ philox,
                         uint32_t drop_thr, float drop_scale) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBars;
  auto full = [&](int s) { return base + L::kBars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::kBars + 8 * (1 + kStages + s); };
  auto ring = [&](int s) { return base + L::kRing + s * L::kStage; };

  // longest first: under causal the first key tiles see the most queries
  const int bh = blockIdx.x % (B * Hkv);
  const int k0 = (blockIdx.x / (B * Hkv)) * kBlockK;
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  const int G = H / Hkv;
  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int qt0 = causal ? k0 / kBlockQ : 0;  // first tile reaching the diagonal

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 32);  // the producer warp's lanes
      hopper::mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warp: lane 0 issues every TMA load; lanes 1-31 copy
    // each stage's 64 lse and delta values ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_expect_tx(bar_kv, 2 * L::kTileK);
        hopper::tma_load_rows<D>(base + L::kK, &tm_k, bar_kv, kBlockK, b, hk,
                                 k0);
        hopper::tma_load_rows<D>(base + L::kV, &tm_v, bar_kv, kBlockK, b, hk,
                                 k0);
      }
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const long row_off = (static_cast<long>(b) * H + h) * S;
        for (int qt = qt0; qt < n_qt; ++qt, ++it) {
          const int s = it % kStages;
          if (it >= kStages)
            hopper::mbar_wait(empty(s), ((it / kStages) - 1) & 1);
          const int q0 = qt * kBlockQ;
          float* s_rows =
              reinterpret_cast<float*>(gbase + L::kRows + s * L::kRowStage);
          if (lane == 0) {
            hopper::mbar_expect_tx(full(s), L::kStage);
            hopper::tma_load_rows<D>(ring(s), &tm_q, full(s), kBlockQ, b, h,
                                     q0);
            hopper::tma_load_rows<D>(ring(s) + L::kTileQ, &tm_do, full(s),
                                     kBlockQ, b, h, q0);
          }
          if (lane != 0) {  // lane 0's arrival came with its expect_tx
            for (int j = lane - 1; j < kBlockQ; j += 31) {
              const bool in = q0 + j < S;
              s_rows[j] = in ? lse[row_off + q0 + j] * kLog2e : 0.f;
              s_rows[kBlockQ + j] = in ? delta[row_off + q0 + j] : 0.f;
            }
            hopper::mbar_arrive(full(s));
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns keys [k0 + 64 c, k0 + 64 c + 64) ----
    hopper::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int kw0 = k0 + c * 64;

    // this thread's keys: accumulator rows gid (elements 0, 1) and gid + 8
    const int kr[2] = {kw0 + warp * 16 + gid, kw0 + warp * 16 + gid + 8};
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      key_ok[r] = kr[r] < S &&
                  (!kv_mask || kv_mask[static_cast<long>(b) * S + kr[r]] > 0.f);

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const float scale_l2 = scale * kLog2e;
    const uint32_t a_k = base + L::kK + c * 64 * 128;
    const uint32_t a_v = base + L::kV + c * 64 * 128;

    philox::MaybeDropout<kDrop> drop(philox, b * H + hk * G, drop_thr);

    hopper::mbar_wait(bar_kv, 0);
    int it = 0;
    for (int g = 0; g < G; ++g) {
      if constexpr (kDrop) drop.bh = b * H + hk * G + g;
      for (int qt = qt0; qt < n_qt; ++qt, ++it) {
        const int s = it % kStages;
        const int q0 = qt * kBlockQ;
        // the tile's keep bits (bit i: accumulator element i), drawn while
        // its loads are in flight: this thread draws the call of its query
        // column `odd` and the lane four away (gid ^ 1) the other; each
        // keeps the two words of its own keys' parity and swaps the rest
        uint32_t keep = 0u;
        if constexpr (kDrop) {
          const bool odd = gid & 1;
          if (!(causal && q0 + kBlockQ - 1 < kw0)) {
#pragma unroll
            for (int g2 = 0; g2 < kBlockQ / 16; ++g2) {
              const uint4 w =
                  drop.call(q0 + 16 * g2 + 2 * tig + (odd ? 1 : 0), kr[0]);
              const uint32_t m0 = odd ? w.z : w.x, m1 = odd ? w.w : w.y;
              const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 4);
              const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 4);
              keep |= (odd ? drop.col_bits(r0, r1, m0, m1)
                           : drop.col_bits(m0, m1, r0, r1))
                      << (8 * g2);
            }
          }
        }
        hopper::mbar_wait(full(s), (it / kStages) & 1);
        if (!(causal && q0 + kBlockQ - 1 < kw0)) {
          const uint32_t sq = ring(s);
          const uint32_t sdo = sq + L::kTileQ;
          const float* s_lse =
              reinterpret_cast<const float*>(gbase + L::kRows + s * L::kRowStage);
          const float* s_dl = s_lse + kBlockQ;
          float st[32], dpt[32];
          hopper::wgmma_fence();
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            const uint32_t off = (j % 4) * 32;
            Wgmma<T, 64, 0>::ss(
                st, hopper::desc_sw128(a_k + (j / 4) * kBlockK * 128 + off, 16, 1024),
                hopper::desc_sw128(sq + (j / 4) * kBlockQ * 128 + off, 16, 1024),
                j > 0);
          }
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            const uint32_t off = (j % 4) * 32;
            Wgmma<T, 64, 0>::ss(
                dpt, hopper::desc_sw128(a_v + (j / 4) * kBlockK * 128 + off, 16, 1024),
                hopper::desc_sw128(sdo + (j / 4) * kBlockQ * 128 + off, 16, 1024),
                j > 0);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<32>(st);
          hopper::fence_regs<32>(dpt);

          // p = 2^(s log2 e - lse log2 e) (lse arrives scaled) and ds =
          // p * (dp - delta); masked scores (and query rows past S) give 0
          const bool interior = !kv_mask && q0 + kBlockQ <= S &&
                                kw0 + 64 <= S && (!causal || kw0 + 63 <= q0);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(s_lse + n * 8 + tig * 2);
            const float2 dl = *reinterpret_cast<const float2*>(s_dl + n * 8 + tig * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * n + e;
              const float lc = (e & 1) ? l2.y : l2.x;
              const float dc = (e & 1) ? dl.y : dl.x;
              float p;
              if (interior) {
                p = hopper::ex2(fmaf(st[i], scale_l2, -lc));
              } else {
                const int qi = q0 + n * 8 + tig * 2 + (e & 1);
                const int row = e >> 1;
                const bool ok =
                    key_ok[row] && qi < S && (!causal || kr[row] <= qi);
                const float sc = ok ? st[i] * scale_l2 : kNeg;
                p = sc <= 0.5f * kNeg ? 0.f : hopper::ex2(sc - lc);
              }
              if constexpr (kDrop) {
                const bool kp = (keep >> i) & 1u;
                st[i] = kp ? p * drop_scale : 0.f;
                dpt[i] = p * ((kp ? dpt[i] * drop_scale : 0.f) - dc);
              } else {
                st[i] = p;
                dpt[i] = p * (dpt[i] - dc);
              }
            }
          }
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            hopper::pack_a<T>(pa[cc], st, cc);
            hopper::pack_a<T>(da[cc], dpt, cc);
          }

          // dv += p^T (64 keys x 64 queries) . do (64 queries x D);
          // dk += ds^T . q; do and q read MN-major
          hopper::wgmma_fence();
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            Wgmma<T, D, 1>::rs(
                dv_acc, pa[cc],
                hopper::desc_sw128(sdo + cc * 16 * 128, kBlockQ * 128, 1024), 1);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            Wgmma<T, D, 1>::rs(
                dk_acc, da[cc],
                hopper::desc_sw128(sq + cc * 16 * 128, kBlockQ * 128, 1024), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<D / 2>(dv_acc);
          hopper::fence_regs<D / 2>(dk_acc);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty(s));
      }
    }

    // epilogue: dk = scale * acc, dv = acc, written in the input dtype
    const long kv_stride = static_cast<long>(Hkv) * D;
    const long kv_off =
        static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kr[r] >= S) continue;
      const long at = kv_off + kr[r] * kv_stride;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + at + n * 8 + tig * 2) =
            hopper::pack2<T>(dk_acc[4 * n + 2 * r] * scale,
                             dk_acc[4 * n + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + n * 8 + tig * 2) =
            hopper::pack2<T>(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <typename T, int D, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* kv_mask, void* dk,
           void* dv, int B, int S, int H, int Hkv, int causal,
           const void* philox, int drop_thr, float drop_scale,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes + 1024;  // + alignment slack
  // above the 48 KB default: raised once per instantiation (on the device
  // current at the first launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  const int n_kt = (S + kBlockK - 1) / kBlockK;
  flash_bwd_dkv_kernel<T, D, kDrop><<<n_kt * B * Hkv, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(kv_mask),
      static_cast<T*>(dk), static_cast<T*>(dv), B, S, H, Hkv, causal,
      1.f / sqrtf(static_cast<float>(D)), static_cast<const int64_t*>(philox),
      static_cast<uint32_t>(drop_thr), drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDrop>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* kv_mask, void* dk,
             void* dv, int B, int S, int H, int Hkv, int D, int causal,
             int dtype, const void* philox, int drop_thr, float drop_scale,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128, kDrop>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64, kDrop>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 1 && D == 128)
    return launch<__half, 128, kDrop>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 1 && D == 64)
    return launch<__half, 64, kDrop>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q / dout [B, S, H, D], k/v and dk/dv [B, S, Hkv, D], lse / delta
// [B, H, S] f32, kv_mask [B, S] f32 or null, all contiguous and 16-byte
// aligned.  dtype: 0 = bf16, 1 = fp16.  Returns a cudaError_t: 0 when the
// launch was accepted.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* kv_mask, void* dk,
                             void* dv, int B, int S, int H, int Hkv, int D,
                             int causal, int dtype, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H,
                         Hkv, D, causal, dtype, nullptr, 0, 1.f, stream);
}

// flash_bwd_dkv with attention dropout: delta from flash_bwd_dq_dropout;
// philox, drop_thr and drop_scale as the forward got them.
extern "C" int flash_bwd_dkv_dropout(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* kv_mask, void* dk, void* dv,
                                     int B, int S, int H, int Hkv, int D,
                                     int causal, int dtype,
                                     const void* philox, int drop_thr,
                                     float drop_scale, void* stream) {
  if (!philox || drop_thr < 0 || drop_thr > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H,
                        Hkv, D, causal, dtype, philox, drop_thr, drop_scale,
                        stream);
}
