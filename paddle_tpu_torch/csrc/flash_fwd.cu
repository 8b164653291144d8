// Flash-attention forward for Hopper (sm_90a): o and per-row lse of
// softmax(scale * q k^T + mask) v, bf16 or fp16 inputs, f32 accumulation.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd_gqa).  Same contract: causal or full attention, an optional key
// mask [B, S] (1 = attend), GQA native (query head h = hk * G + g reads
// kv head hk), fully masked rows give exact zeros, lse kept for the
// backward kernels.
//
// What bounds it: at the prefill shapes (S up to 2048, D = 128) the work
// is 4 * S^2 * D FLOPs per head (halved under causal) against O(S * D)
// bytes, far above the H100's ~295 FLOP/byte ridge, so the tensor cores
// bound it.  The design therefore keeps the S x S scores out of device
// memory (online softmax over 64-key tiles held in registers) and runs
// both products on the tensor cores with mma.sync m16n8k16 (f32
// accumulate).  Under causal a q tile stops at the diagonal.  Not done
// yet: wgmma, TMA and a multi-stage K/V ring (tiles are loaded
// synchronously, one at a time).
//
// Layout: one thread block = 4 warps = one 64-row q tile of one
// (batch, query head); each warp owns 16 q rows.  K/V tiles of 64 keys
// are staged in shared memory with rows padded by 8 elements so the
// 32-bit fragment loads are bank-conflict free.  Rows and keys past S
// (prefill buckets of 16, 32, 48 ... tokens) are masked in the kernel.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t ld16(const T* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

// Copy `rows` rows of D elements (row stride `stride` elements in global
// memory) into shared memory rows of `ld` elements; rows at or past
// `valid` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long stride,
                                          int valid, int ld) {
  constexpr int kVec = 8;  // elements per 16-byte vector
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < 64 * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kv_mask,
                     T* __restrict__ o, float* __restrict__ lse, int S, int H,
                     int Hkv, int causal, float scale) {
  constexpr int kLd = D + 8;
  constexpr int kDChunks = D / 16;  // k16 steps of q k^T
  constexpr int kDTiles = D / 8;    // n8 tiles of the output
  constexpr int kKTiles = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockQ * kLd;
  T* sV = sK + kBlockK * kLd;
  float* sM = reinterpret_cast<float*>(sV + kBlockK * kLd);

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row within the 8-row group
  const int tig = lane & 3;   // thread in group: fragment column pair

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const T* qb = q + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  const T* kb = k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
  const T* vb = v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  load_tile<T, D>(sQ, qb + q0 * q_stride, q_stride, S - q0, kLd);
  __syncthreads();

  // this warp's 16 q rows as A fragments for every k16 chunk of D
  const int r0 = warp * 16 + gid;
  uint32_t qf[kDChunks][4];
#pragma unroll
  for (int c = 0; c < kDChunks; ++c) {
    const T* base = sQ + c * 16 + tig * 2;
    qf[c][0] = ld32(base + r0 * kLd);
    qf[c][1] = ld32(base + (r0 + 8) * kLd);
    qf[c][2] = ld32(base + r0 * kLd + 8);
    qf[c][3] = ld32(base + (r0 + 8) * kLd + 8);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_i[2] = {kNeg, kNeg};
  float l_i[2] = {0.f, 0.f};
  const int qi[2] = {q0 + r0, q0 + r0 + 8};

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kb + k0 * kv_stride, kv_stride, S - k0, kLd);
    load_tile<T, D>(sV, vb + k0 * kv_stride, kv_stride, S - k0, kLd);
    for (int j = threadIdx.x; j < kBlockK; j += kThreads) {
      const int key = k0 + j;
      sM[j] = key < S ? (kv_mask ? kv_mask[static_cast<long>(b) * S + key] : 1.f)
                      : 0.f;
    }
    __syncthreads();

    // scores for 16 rows x 64 keys: kKTiles n8 tiles
    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) {
        const T* kr = sK + (nt * 8 + gid) * kLd + c * 16 + tig * 2;
        uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        Mma<T>::run(s[nt], qf[c], bf);
      }
    }

    // mask, scale, running row max (rows r0 -> e 0,1 ; r0 + 8 -> e 2,3)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const bool ok = sM[col] > 0.f && (!causal || k0 + col <= qi[e >> 1]);
        const float val = ok ? s[nt][e] * scale : kNeg;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = s[nt][e];
        const float p = val <= 0.5f * kNeg ? 0.f : __expf(val - mx[e >> 1]);
        s[nt][e] = p;
        rowsum[e >> 1] += p;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
      alpha[r] = __expf(m_i[r] - mx[r]);
      l_i[r] = l_i[r] * alpha[r] + rowsum[r];
      m_i[r] = mx[r];
    }
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    // acc += p v: the score accumulators of n8 tiles 2c and 2c + 1 are
    // exactly the A fragment of the k16 chunk c
#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) {
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[2 * c][0], s[2 * c][1]);
      pa[1] = Mma<T>::pack(s[2 * c][2], s[2 * c][3]);
      pa[2] = Mma<T>::pack(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int t = 0; t < kDTiles; ++t) {
        const T* vr = sV + (c * 16 + tig * 2) * kLd + t * 8 + gid;
        uint32_t bf[2];
        bf[0] = ld16(vr) | (ld16(vr + kLd) << 16);
        bf[1] = ld16(vr + 8 * kLd) | (ld16(vr + 9 * kLd) << 16);
        Mma<T>::run(acc[t], pa, bf);
      }
    }
  }

  // epilogue: o = acc / l (exact zeros for fully masked rows), lse = m + log l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= S) continue;
    const float l = fmaxf(l_i[r], 1e-30f);
    const float inv = 1.f / l;
    T* orow = o + static_cast<long>(b) * S * q_stride + qi[r] * q_stride +
              static_cast<long>(h) * D;
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      *reinterpret_cast<uint32_t*>(orow + t * 8 + tig * 2) =
          Mma<T>::pack(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
    }
    if (tig == 0)
      lse[(static_cast<long>(b) * H + h) * S + qi[r]] = m_i[r] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* o, void* lse, int B, int S, int H, int Hkv, int causal,
           cudaStream_t stream) {
  constexpr size_t smem =
      static_cast<size_t>(kBlockQ + 2 * kBlockK) * (D + 8) * sizeof(T) +
      kBlockK * sizeof(float);
  // above the 48 KB default at D = 128: raise the limit once per
  // instantiation (on the device current at the first launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<T*>(o), static_cast<float*>(lse), S, H, Hkv, causal,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, D], k/v [B, S, Hkv, D], kv_mask [B, S] f32 or null, all
// contiguous; o like q; lse [B, H, S] f32.  dtype: 0 = bf16, 1 = fp16.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* o, void* lse, int B, int S,
                         int H, int Hkv, int D, int causal, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, st);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, st);
  if (dtype == 1 && D == 128)
    return launch<__half, 128>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, st);
  if (dtype == 1 && D == 64)
    return launch<__half, 64>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
