// int8 quantized matmul for Hopper (sm_90a): y = (qx . qw in exact int32)
// * sx * sw, written as bf16, fp16 or f32.
//
// Replaces: paddle_tpu/ops/quantized_matmul.py:_qmm_kernel (launched by
// _qmm_pallas).  Same contract: qx [M, K] int8 activation codes with one
// f32 scale per row (sx [M, 1]), weight codes with one f32 scale per
// output column (sw [1, N]), int32 accumulation (exact), then the f32
// rescale (acc * sx) * sw in that order and one rounding to the output
// type, so the kernel equals the plain version bit for bit.  The weight
// codes come in transposed, qw_t [N, K]: mma.sync's int8 shape takes both
// operands K-contiguous and ldmatrix .trans moves only 16-bit elements, so
// the wrapper writes the codes that way (its quantizer already reduces
// over K) instead of this kernel transposing bytes through shared memory.
//
// What bounds it: at decode (M = 8) the weight codes, K * N bytes read once
// (bytes-bound: 12.6 MB for the 2048 x 6144 qkv projection); at a chunk
// tick (M = 4096) the 2 M N K integer operations (operations-bound at the
// int8 tensor-core rate).  The design: mma.sync m16n8k32 s8 x s8 -> s32
// tensor-core products over shared-memory tiles of 128 k bytes, filled by
// cp.async in a ring of stages so several tiles are in flight per block;
// three tile shapes by M: 16 x 64 tiles with 8 stages for decode (M <= 16,
// a deep ring to keep the weight stream moving), 64 x 64 for M <= 64, and
// 128 x 128 with 3 stages above.  Rows past M read zeros and are not
// written.  Not done yet: int8 wgmma, TMA, split-K for the narrow
// projections at decode.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;       // k bytes per stage
constexpr int kLd = kBK + 16;  // padded shared row: 36 words, conflict-free fragment loads

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// One block: a BM x BN tile of y.  Warps tile it WARPS_M x WARPS_N; a warp
// owns (BM / WARPS_M) x (BN / WARPS_N) as 16 x 8 mma tiles.  Fragment
// layouts of m16n8k32 (lane = 4 * gid + tig): A rows gid / gid + 8, k bytes
// 4 * tig .. + 3 and 16 + 4 * tig .. + 3; B column gid, the same k bytes;
// C rows gid / gid + 8, columns 2 * tig, 2 * tig + 1.
template <typename TO, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    qmm_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw_t,
               const float* __restrict__ sx, const float* __restrict__ sw,
               TO* __restrict__ y, int M, int N, int K) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int kWTM = BM / WARPS_M;
  constexpr int kWTN = BN / WARPS_N;
  constexpr int kMT = kWTM / 16;
  constexpr int kNT = kWTN / 8;
  constexpr int kChunks = kBK / 16;  // 16-byte copies per tile row
  constexpr int kStage = (BM + BN) * kLd;
  extern __shared__ __align__(16) int8_t smem[];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int nk = K / kBK;

  auto load_stage = [&](int s, int kt) {
    int8_t* sa = smem + s * kStage;
    int8_t* sb = sa + BM * kLd;
    const long k0 = static_cast<long>(kt) * kBK;
    for (int i = threadIdx.x; i < BM * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 16;
      const bool ok = m0 + r < M;
      cp_async16(sa + r * kLd + c, qx + (ok ? static_cast<long>(m0 + r) * K : 0) + k0 + c, ok);
    }
    for (int i = threadIdx.x; i < BN * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 16;
      cp_async16(sb + r * kLd + c, qw_t + static_cast<long>(n0 + r) * K + k0 + c, true);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const int8_t* sa = smem + (kt % STAGES) * kStage;
    const int8_t* sb = sa + BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int8_t* p = sa + (wm * kWTM + mt * 16 + gid) * kLd + kk + tig * 4;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * kLd);
        af[mt][2] = ld32(p + 16);
        af[mt][3] = ld32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int8_t* p = sb + (wn * kWTN + nt * 8 + gid) * kLd + kk + tig * 4;
        bf[nt][0] = ld32(p);
        bf[nt][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  // epilogue: (float(acc) * sx) * sw, each product rounded on its own
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kWTM + mt * 16 + gid + half * 8;
      if (row >= M) continue;
      const float sr = sx[row];
      TO* yr = y + static_cast<long>(row) * N;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + wn * kWTN + nt * 8 + tig * 2;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sr), sw[col]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), sr), sw[col + 1]);
        store2<TO>(yr + col, v0, v1);
      }
    }
  }
}

template <typename TO, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
int launch(const void* qx, const void* qw_t, const void* sx, const void* sw, void* y, int M,
           int N, int K, cudaStream_t stream) {
  constexpr size_t kSmem = static_cast<size_t>(STAGES) * (BM + BN) * kLd;
  auto kernel = qmm_kernel<TO, BM, BN, WARPS_M, WARPS_N, STAGES>;
  static bool configured = false;  // once per template instance
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, WARPS_M * WARPS_N * 32, kSmem, stream>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(qw_t), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<TO*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int by_m(const void* qx, const void* qw_t, const void* sx, const void* sw, void* y, int M, int N,
         int K, cudaStream_t stream) {
  if (M <= 16) return launch<TO, 16, 64, 1, 4, 8>(qx, qw_t, sx, sw, y, M, N, K, stream);
  if (M <= 64) return launch<TO, 64, 64, 2, 2, 4>(qx, qw_t, sx, sw, y, M, N, K, stream);
  return launch<TO, 128, 128, 2, 4, 3>(qx, qw_t, sx, sw, y, M, N, K, stream);
}

}  // namespace

// qx [M, K] int8, qw_t [N, K] int8 (the weight codes transposed), sx [M]
// f32, sw [N] f32, y [M, N]; all contiguous and 16-byte aligned.  M >= 1,
// N and K multiples of 128.  dtype of y: 0 = bf16, 1 = fp16, 2 = f32.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int quantized_matmul(const void* qx, const void* qw_t, const void* sx, const void* sw,
                                void* y, int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 128 != 0 || K % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_m<__nv_bfloat16>(qx, qw_t, sx, sw, y, M, N, K, s);
  if (dtype == 1) return by_m<__half>(qx, qw_t, sx, sw, y, M, N, K, s);
  if (dtype == 2) return by_m<float>(qx, qw_t, sx, sw, y, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
