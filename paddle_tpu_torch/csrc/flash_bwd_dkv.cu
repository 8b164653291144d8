// Flash-attention backward, dk and dv, for Hopper (sm_90a): bf16 or fp16
// inputs, f32 accumulation.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_bwd_dkv_kernel (launched by
// _bwd_gqa).  Same math, per key j: dv_j = sum_i p_ij do_i with p rounded
// to the input dtype, dk_j = scale * sum_i ds_ij q_i with ds = p * (dp -
// delta) rounded likewise, p = exp(scale * q k^T - lse) recomputed from the
// forward's lse (0 where the score is masked), dp = do v^T, delta =
// rowsum(do * o) from the wrapper.  Both sums also run over the G query
// heads of the kv head's group.  Causal or full, an optional key mask
// [B, S], any S (rows and keys past S are masked here).
//
// What bounds it: four products of 2 * S * Sk * D FLOPs per head (k q^T,
// v do^T, p^T do, ds^T q; halved under causal) against O(S * D) bytes, so
// the tensor cores bound it at training shapes.  The design keeps p and
// ds in registers, runs all four products on mma.sync m16n8k16 with f32
// accumulation, and under causal starts each key tile's query loop at the
// diagonal.  The TPU kernel accumulates dk/dv over a sequential grid
// dimension g in place; blocks on the GPU run in no order, so here one
// block loops over the whole group itself and keeps dk and dv in f32
// registers for it: no atomics and no second pass, and results are
// deterministic.  Each 64-query tile is processed in 16-query chunks: the
// p and ds accumulators of one chunk become the A fragments of p^T do
// and ds^T q directly.  Not done yet: wgmma, TMA and a multi-stage Q/dO
// ring (tiles are loaded synchronously).
//
// Layout: one thread block = 4 warps = one 64-key tile of one (batch,
// kv head); each warp owns 16 keys and their dk/dv rows.
#include "mma_tile.cuh"

namespace {

using flash::kNeg;
using flash::Mma;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kv_mask,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                         int Hkv, int causal, float scale) {
  constexpr int kLd = D + 8;
  constexpr int kDChunks = D / 16;  // k16 steps over D
  constexpr int kDTiles = D / 8;    // n8 tiles of dk / dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBlockK * kLd;
  T* sQ = sV + kBlockK * kLd;
  T* sDO = sQ + kBlockQ * kLd;
  float* sL = reinterpret_cast<float*>(sDO + kBlockQ * kLd);
  float* sDl = sL + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long kv_off = static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  flash::load_tile<T, D, kThreads>(sK, k + kv_off + k0 * kv_stride, kv_stride, S - k0, kLd);
  flash::load_tile<T, D, kThreads>(sV, v + kv_off + k0 * kv_stride, kv_stride, S - k0, kLd);

  // this thread's two keys (fragment rows gid and gid + 8 of the warp)
  const int kr[2] = {k0 + warp * 16 + gid, k0 + warp * 16 + gid + 8};
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = kr[r] < S &&
                (!kv_mask || kv_mask[static_cast<long>(b) * S + kr[r]] > 0.f);

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int qt0 = causal ? k0 / kBlockQ : 0;  // first tile reaching the diagonal

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    const long l_off = (static_cast<long>(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      flash::load_tile<T, D, kThreads>(sQ, q + q_off + q0 * q_stride, q_stride, S - q0, kLd);
      flash::load_tile<T, D, kThreads>(sDO, dout + q_off + q0 * q_stride, q_stride, S - q0, kLd);
      for (int j = threadIdx.x; j < kBlockQ; j += kThreads) {
        const bool in = q0 + j < S;
        sL[j] = in ? lse[l_off + q0 + j] : 0.f;
        sDl[j] = in ? delta[l_off + q0 + j] : 0.f;
      }
      __syncthreads();

      // 16 queries at a time: n8 tiles 2c and 2c + 1 of s^T = k q^T and
      // dp^T = v do^T (rows: this warp's keys)
#pragma unroll 1
      for (int c = 0; c < kBlockQ / 16; ++c) {
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int dc = 0; dc < kDChunks; ++dc) {
          uint32_t ka[4], va[4];
          flash::load_a(ka, sK, kLd, warp * 16, dc * 16, gid, tig);
          flash::load_a(va, sV, kLd, warp * 16, dc * 16, gid, tig);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t bq[2], bd[2];
            flash::load_b_rows(bq, sQ, kLd, c * 16 + j * 8, dc * 16, gid, tig);
            flash::load_b_rows(bd, sDO, kLd, c * 16 + j * 8, dc * 16, gid, tig);
            Mma<T>::run(st[j], ka, bq);
            Mma<T>::run(dpt[j], va, bd);
          }
        }
        // p and ds = p * (dp - delta); masked scores (and query rows past
        // S) give 0
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c * 16 + j * 8 + tig * 2 + (e & 1);
            const int qi = q0 + col;
            const int row = e >> 1;
            const bool ok = key_ok[row] && qi < S && (!causal || kr[row] <= qi);
            const float sv = ok ? st[j][e] * scale : kNeg;
            const float p = sv <= 0.5f * kNeg ? 0.f : __expf(sv - sL[col]);
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - sDl[col]);
          }
        }
        uint32_t pa[4], da[4];
        pa[0] = Mma<T>::pack(st[0][0], st[0][1]);
        pa[1] = Mma<T>::pack(st[0][2], st[0][3]);
        pa[2] = Mma<T>::pack(st[1][0], st[1][1]);
        pa[3] = Mma<T>::pack(st[1][2], st[1][3]);
        da[0] = Mma<T>::pack(dpt[0][0], dpt[0][1]);
        da[1] = Mma<T>::pack(dpt[0][2], dpt[0][3]);
        da[2] = Mma<T>::pack(dpt[1][0], dpt[1][1]);
        da[3] = Mma<T>::pack(dpt[1][2], dpt[1][3]);
        // dv += p^T (16 keys x 16 queries) . do (16 queries x D);
        // dk += ds^T . q
#pragma unroll
        for (int t = 0; t < kDTiles; ++t) {
          uint32_t bd[2], bq[2];
          flash::load_b_cols(bd, sDO, kLd, c * 16, t * 8, gid, tig);
          flash::load_b_cols(bq, sQ, kLd, c * 16, t * 8, gid, tig);
          Mma<T>::run(dv_acc[t], pa, bd);
          Mma<T>::run(dk_acc[t], da, bq);
        }
      }
    }
  }

  // epilogue: dk = scale * acc, dv = acc, written in the input dtype
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= S) continue;
    const long at = kv_off + kr[r] * kv_stride;
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      *reinterpret_cast<uint32_t*>(dk + at + t * 8 + tig * 2) =
          Mma<T>::pack(dk_acc[t][2 * r] * scale, dk_acc[t][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + t * 8 + tig * 2) =
          Mma<T>::pack(dv_acc[t][2 * r], dv_acc[t][2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* kv_mask, void* dk,
           void* dv, int B, int S, int H, int Hkv, int causal,
           cudaStream_t stream) {
  constexpr size_t smem =
      static_cast<size_t>(2 * kBlockK + 2 * kBlockQ) * (D + 8) * sizeof(T) +
      2 * kBlockQ * sizeof(float);
  // K, V, Q and dO tiles: 70 KB at D = 128, above the 48 KB default; the
  // limit is raised once per instantiation (on the device current at the
  // first launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kBlockK - 1) / kBlockK, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(kv_mask), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, Hkv, causal,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q / dout [B, S, H, D], k/v and dk/dv [B, S, Hkv, D], lse / delta
// [B, H, S] f32, kv_mask [B, S] f32 or null, all contiguous.  dtype:
// 0 = bf16, 1 = fp16.  Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* kv_mask, void* dk,
                             void* dv, int B, int S, int H, int Hkv, int D,
                             int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, st);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, st);
  if (dtype == 1 && D == 128)
    return launch<__half, 128>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, st);
  if (dtype == 1 && D == 64)
    return launch<__half, 64>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, S, H, Hkv, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
