// Flash-attention backward, dq, for Hopper (sm_90a): bf16 or fp16 inputs,
// f32 accumulation.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_bwd_dq_kernel (launched by
// _bwd_gqa).  Same math: with p = exp(scale * q k^T - lse) recomputed
// from the forward's per-row lse (0 where the score is masked: the
// `s <= -1e30 / 2` rule, so a fully masked row gives p = 0 rather than
// exp(-1e30 + 1e30) = 1), dp = do v^T and delta = rowsum(do * o) (computed
// by the wrapper from the saved o), ds = p * (dp - delta) rounded to the
// input dtype, dq = scale * ds k.  Causal or full, an optional key mask
// [B, S] (1 = attend), GQA native (query head h = hk * G + g reads kv
// head hk), any S (rows and keys past S are masked here).
//
// What bounds it: three products of 2 * S * Sk * D FLOPs per head (q k^T,
// do v^T, ds k; halved under causal) against O(S * D) bytes, so the
// tensor cores bound it at training shapes (S = 2048, D = 128: ~500 FLOP
// per byte).  The design keeps the S x S tiles of p and ds in registers
// (never in device memory), runs all three products on mma.sync m16n8k16
// with f32 accumulation, keeps this warp's q and do rows in registers as
// A fragments for the whole key loop, and stops at the diagonal under
// causal.  Each 64-key tile is processed in 16-key chunks: the score and
// dp accumulators of one chunk become the A fragment of ds k directly, so
// only 16 f32 values of p / dp are live per thread.  Not done yet: wgmma,
// TMA and a multi-stage K/V ring (tiles are loaded synchronously).
//
// Layout: one thread block = 4 warps = one 64-row q tile of one (batch,
// query head); each warp owns 16 q rows.  No atomics: each block writes
// its own dq rows, so results are deterministic.
#include "mma_tile.cuh"

namespace {

using flash::kNeg;
using flash::Mma;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kv_mask, T* __restrict__ dq,
                        int S, int H, int Hkv, int causal, float scale) {
  constexpr int kLd = D + 8;
  constexpr int kDChunks = D / 16;  // k16 steps over D
  constexpr int kDTiles = D / 8;    // n8 tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + kBlockQ * kLd;
  T* sK = sDO + kBlockQ * kLd;
  T* sV = sK + kBlockK * kLd;
  float* sM = reinterpret_cast<float*>(sV + kBlockK * kLd);

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  const T* kb = k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
  const T* vb = v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  flash::load_tile<T, D, kThreads>(sQ, q + q_off + q0 * q_stride, q_stride, S - q0, kLd);
  flash::load_tile<T, D, kThreads>(sDO, dout + q_off + q0 * q_stride, q_stride, S - q0, kLd);
  __syncthreads();

  // this warp's 16 q and do rows as A fragments for every k16 chunk of D
  uint32_t qf[kDChunks][4], df[kDChunks][4];
#pragma unroll
  for (int c = 0; c < kDChunks; ++c) {
    flash::load_a(qf[c], sQ, kLd, warp * 16, c * 16, gid, tig);
    flash::load_a(df[c], sDO, kLd, warp * 16, c * 16, gid, tig);
  }

  // rows r0 (fragment elements 0, 1) and r0 + 8 (elements 2, 3)
  const int r0 = warp * 16 + gid;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long at = (static_cast<long>(b) * H + h) * S + qi[r];
    lse_r[r] = qi[r] < S ? lse[at] : 0.f;
    dl_r[r] = qi[r] < S ? delta[at] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::load_tile<T, D, kThreads>(sK, kb + k0 * kv_stride, kv_stride, S - k0, kLd);
    flash::load_tile<T, D, kThreads>(sV, vb + k0 * kv_stride, kv_stride, S - k0, kLd);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads) {
      const int key = k0 + j;
      sM[j] = key < S ? (kv_mask ? kv_mask[static_cast<long>(b) * S + key] : 1.f)
                      : 0.f;
    }
    __syncthreads();

    // 16 keys at a time: n8 tiles 2c and 2c + 1 of s = q k^T and dp = do v^T
#pragma unroll 1
    for (int c = 0; c < kBlockK / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int dc = 0; dc < kDChunks; ++dc) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bk[2], bv[2];
          flash::load_b_rows(bk, sK, kLd, c * 16 + j * 8, dc * 16, gid, tig);
          flash::load_b_rows(bv, sV, kLd, c * 16 + j * 8, dc * 16, gid, tig);
          Mma<T>::run(s[j], qf[dc], bk);
          Mma<T>::run(dp[j], df[dc], bv);
        }
      }
      // ds = p * (dp - delta), p recomputed from lse; masked scores give 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + j * 8 + tig * 2 + (e & 1);
          const int row = e >> 1;
          const bool ok = sM[col] > 0.f && (!causal || k0 + col <= qi[row]);
          const float sv = ok ? s[j][e] * scale : kNeg;
          const float p = sv <= 0.5f * kNeg ? 0.f : __expf(sv - lse_r[row]);
          s[j][e] = p * (dp[j][e] - dl_r[row]);
        }
      }
      uint32_t da[4];
      da[0] = Mma<T>::pack(s[0][0], s[0][1]);
      da[1] = Mma<T>::pack(s[0][2], s[0][3]);
      da[2] = Mma<T>::pack(s[1][0], s[1][1]);
      da[3] = Mma<T>::pack(s[1][2], s[1][3]);
      // dq += ds (16 rows x 16 keys) . k (16 keys x D)
#pragma unroll
      for (int t = 0; t < kDTiles; ++t) {
        uint32_t bk[2];
        flash::load_b_cols(bk, sK, kLd, c * 16, t * 8, gid, tig);
        Mma<T>::run(acc[t], da, bk);
      }
    }
  }

  // epilogue: dq = scale * acc, written in the input dtype
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= S) continue;
    T* row = dq + q_off + qi[r] * q_stride;
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      *reinterpret_cast<uint32_t*>(row + t * 8 + tig * 2) =
          Mma<T>::pack(acc[t][2 * r] * scale, acc[t][2 * r + 1] * scale);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* kv_mask, void* dq,
           int B, int S, int H, int Hkv, int causal, cudaStream_t stream) {
  constexpr size_t smem =
      static_cast<size_t>(2 * kBlockQ + 2 * kBlockK) * (D + 8) * sizeof(T) +
      kBlockK * sizeof(float);
  // Q, dO, K and V tiles: 70 KB at D = 128, above the 48 KB default; the
  // limit is raised once per instantiation (on the device current at the
  // first launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(kv_mask), static_cast<T*>(dq), S, H, Hkv,
      causal, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q / dout / dq [B, S, H, D], k/v [B, S, Hkv, D], lse / delta [B, H, S]
// f32, kv_mask [B, S] f32 or null, all contiguous.  dtype: 0 = bf16,
// 1 = fp16.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kv_mask, void* dq,
                            int B, int S, int H, int Hkv, int D, int causal,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, kv_mask, dq, B, S, H, Hkv, causal, st);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, kv_mask, dq, B, S, H, Hkv, causal, st);
  if (dtype == 1 && D == 128)
    return launch<__half, 128>(q, k, v, dout, lse, delta, kv_mask, dq, B, S, H, Hkv, causal, st);
  if (dtype == 1 && D == 64)
    return launch<__half, 64>(q, k, v, dout, lse, delta, kv_mask, dq, B, S, H, Hkv, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
