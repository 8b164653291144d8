// The quantized matmul's kernels for Hopper (sm_90a), templated over the
// code type (Cd below): int8 codes with int32 sums (quantized_matmul.cu,
// whose header note gives the contract and the design of both regimes)
// and e4m3 codes with f32 sums (quantized_matmul_f8.cu).  Both take the
// same plan, tensor maps, ring and workspace: the codes are bytes either
// way.  What e4m3 changes: the tensor-core instructions (mma.sync
// m16n8k32 and wgmma m64n128k32 .f32.e4m3.e4m3), each 128-deep k-tile's
// sum added into f32 registers, 128-column prefill tiles, and split sums
// added in piece order instead of in arrival order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

#define QMM_REGS128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define QMM_ACC64(d) \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
    "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
    "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
    "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
    "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
    "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
    "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
    "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
    "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define QMM_ACC128(d) \
    QMM_ACC64(d), \
    "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), \
    "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), \
    "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), \
    "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
    "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), \
    "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), \
    "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), \
    "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), \
    "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), \
    "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), \
    "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])

namespace qmm {

constexpr int kBK = 128;        // k bytes a stage: one 128-byte swizzle line
constexpr int kMaxSmem = 232448;

// ---- decode regime ----------------------------------------------------------
constexpr int kStrip = 64;                           // output columns a unit
constexpr int kDecWarps = 4;                         // consumer warps, 16 columns each
constexpr int kDecThreads = 32 * (kDecWarps + 1);    // + the producer warp
constexpr int kTileW = kStrip * kBK;                 // 8 KB of weight codes a unit
constexpr int kDecStage = kTileW + 16 * kBK;         // + up to 16 activation rows
constexpr int kDecStages = 8;
static_assert(kDecStages >= 2 && kDecStages * kDecStage + 1024 + 256 <= kMaxSmem,
              "decode ring: at least two stages, within shared memory");

// ---- prefill regime ---------------------------------------------------------
constexpr int kSmemBudget = 229376;  // the prefill ring and the output staging
constexpr int kStaging = 32768;      // a consumer warpgroup's output staging: 64 rows x 512 bytes

template <int kWG, int BN>
struct Ring {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kStage = (kBM + BN) * kBK;  // A then B, each 1024-aligned
  static constexpr int kFit = (kSmemBudget - kWG * kStaging) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kStagingAt = kStages * kStage;
  static constexpr int kSmem = kStagingAt + kWG * kStaging + 16 * kStages + 16 + 1024;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "prefill ring: at least two stages");
};

// The decode split of a product's units over G blocks.  Unit t (t < total)
// is k-tile t % nk of strip t / nk; block b takes units [start(b),
// start(b + 1)), so the blocks' byte counts differ by one unit at most.
// The pieces of strip s are held by blocks blk(s nk) .. blk(s nk + nk - 1);
// the piece of block b writes partial b - blk(s nk) of the strip.
struct Part {
  int nk, total, G;
  __host__ __device__ Part(int N, int K, int G_) : nk(K / kBK), total((N / kStrip) * (K / kBK)), G(G_) {}
  __host__ __device__ int start(int b) const {
    return static_cast<int>(static_cast<long long>(b) * total / G);
  }
  // the block whose run holds unit t
  __host__ __device__ int blk(int t) const {
    return static_cast<int>((static_cast<long long>(t + 1) * G - 1) / total);
  }
  __host__ __device__ int pieces(int strip) const {
    return blk(strip * nk + nk - 1) - blk(strip * nk) + 1;
  }
  __host__ int max_pieces() const {
    int m = 1;
    for (int s = 0; s < total / nk; ++s) m = pieces(s) > m ? pieces(s) : m;
    return m;
  }
};

struct Params {
  CUtensorMap tm_x;   // qx [M, K]: boxes of 128 bytes x (8 NT | BM) rows
  CUtensorMap tm_w;   // qw_t [N, K]: boxes of 128 bytes x (64 | BN) rows
  CUtensorMap tm_y;   // prefill: y [M, N], boxes of 128 bytes x 64 rows
  const float* sx;
  const float* sw;
  void* y;
  int4* work;         // partials, in fragment order
  int* counters;      // one per strip (decode) or tile (prefill), zero between launches
  int M, N, K, dtype;
  int splits;         // prefill: k splits a tile
  int pieces;         // decode: partial slots a strip
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
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

// c += a (16 x 32, row) . b (32 x 8, col), e4m3 in, f32 accumulate
__device__ __forceinline__ void mma_e4m3(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// WgmmaS8<BN>::ss: d[64 x BN] (+)= A[64 x 32] . B[32 x BN]^T in int32, both
// operands 8-bit, K-major, from shared memory; `accumulate` = 0 overwrites
// d.  Accumulator layout as hopper_tile.cuh's m64nNk16 (t = 0 .. BN / 8 - 1).
template <int BN>
struct WgmmaS8;

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void ss(int* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HT_REGS64
        ", %64, %65, p;\n}\n"
        : QMM_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void ss(int* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " QMM_REGS128
        ", %128, %129, p;\n}\n"
        : QMM_ACC128(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// WgmmaE4M3<BN>::ss: d[64 x BN] (+)= A[64 x 32] . B[32 x BN]^T in f32, both
// operands e4m3, K-major, from shared memory; `accumulate` = 0 overwrites
// d.  Only BN = 128: the e4m3 tile keeps a second f32 sum beside it.
template <int BN>
struct WgmmaE4M3;

template <>
struct WgmmaE4M3<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " HT_REGS64
        ", %64, %65, p, 1, 1;\n}\n"
        : HT_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <int kN>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The two code types, as the kernels below take them (Cd):
// S8: int8 codes, int32 sums, exact in any order.
struct S8 {
  using Acc = int;
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ void mma(int* c, const uint32_t* a, const uint32_t* b) {
    mma_s8(c, a, b);
  }
  template <int BN>
  static __device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b, int accumulate) {
    WgmmaS8<BN>::ss(d, a, b, accumulate);
  }
};

// E4M3: e4m3 codes, f32 sums.  The tensor cores' own f32 sum keeps fewer
// bits than an f32 register, so each 128-deep k-tile's sum starts at 0
// and is added into f32 registers (promotion); split pieces are added in
// piece order, so a call is bitwise repeatable.
struct E4M3 {
  using Acc = float;
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_e4m3(c, a, b);
  }
  template <int BN>
  static __device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b, int accumulate) {
    WgmmaE4M3<BN>::ss(d, a, b, accumulate);
  }
};

__device__ __forceinline__ float to_f(int acc) { return __int2float_rn(acc); }
__device__ __forceinline__ float to_f(float acc) { return acc; }
__device__ __forceinline__ int to_bits(int acc) { return acc; }
__device__ __forceinline__ int to_bits(float acc) { return __float_as_int(acc); }
__device__ __forceinline__ void add_bits(int& acc, int bits) { acc += bits; }
__device__ __forceinline__ void add_bits(float& acc, int bits) { acc += __int_as_float(bits); }

// (acc * sx) * sw, each product rounded on its own
template <typename A>
__device__ __forceinline__ float rescale(A acc, float sr, float sc) {
  return __fmul_rn(__fmul_rn(to_f(acc), sr), sc);
}

// y[idx] in the output type: 0 bf16, 1 fp16, 2 f32
__device__ __forceinline__ void store1(void* y, long idx, int dtype, float v) {
  if (dtype == 0)
    static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16_rn(v);
  else if (dtype == 1)
    static_cast<__half*>(y)[idx] = __float2half_rn(v);
  else
    static_cast<float*>(y)[idx] = v;
}

// The arrival of one piece of a split sum: the consumer threads (`threads`
// of them, on named barrier 1) have each written their partial; thread
// `leader` counts the arrival.  True (for every thread) in the last piece
// to arrive, which resets the counter and may then read the others.  The
// first barrier orders every thread's partial before the leader's
// acquire-release atomic (its release covers them); the second passes its
// acquire on to the threads that read the others' partials.  Two full
// fences (__threadfence before the arrival and after) cost 4-9% of a
// decode product on an H100.
__device__ __forceinline__ bool arrive_last(int* counter, int n, volatile int* flag, bool leader,
                                            int threads) {
  hopper::named_sync(1, threads);
  if (leader) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    *flag = old == n - 1;
    if (old == n - 1) *counter = 0;  // every piece has arrived: clean for the next launch
  }
  hopper::named_sync(1, threads);
  return *flag;
}

template <class Cd, int NT>
__global__ void __launch_bounds__(kDecThreads, 1) decode_kernel(const __grid_constant__ Params p) {
  using Acc = typename Cd::Acc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + kDecStages * kDecStage;
  volatile int* flag = reinterpret_cast<volatile int*>(
      smem_raw + (bars - raw) + 16 * kDecStages);
  const Part pt(p.N, p.K, gridDim.x);
  const int u0 = pt.start(blockIdx.x), u1 = pt.start(blockIdx.x + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // thread 0 (the producer) prefetches the tensor maps, makes the barriers
  // and starts loading at once; the consumers alone wait for the barriers
  // (2-6% at the gpt3-1.3b products on an H100, against a __syncthreads)
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&p.tm_w)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&p.tm_x)) : "memory");
    for (int s = 0; s < kDecStages; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (kDecStages + s), kDecWarps);
    }
    hopper::mbar_init_fence();
  }
  if (warp == 0)
    asm volatile("bar.arrive 3, %0;\n" ::"n"(kDecThreads) : "memory");
  else
    asm volatile("bar.sync 3, %0;\n" ::"n"(kDecThreads) : "memory");

  if (warp == 0) {  // the producer
    if (lane == 0) {
      for (int u = u0, i = 0; u < u1; ++u, ++i) {
        const int s = i % kDecStages;
        if (i >= kDecStages) hopper::mbar_wait(bars + 8 * (kDecStages + s), ((i / kDecStages) - 1) & 1);
        const uint32_t full = bars + 8 * s, dst = base + s * kDecStage;
        hopper::mbar_expect_tx(full, kTileW + NT * 8 * kBK);
        const int kt = u % pt.nk;
        hopper::tma_load_2d(dst, &p.tm_w, full, kt * kBK, (u / pt.nk) * kStrip);
        hopper::tma_load_2d(dst + kTileW, &p.tm_x, full, kt * kBK, 0);
      }
    }
    return;
  }

  // consumer warp w: output columns 16 w .. 16 w + 15 of each strip.  A
  // fragment (weights): columns gid / gid + 8, k bytes 4 tig.. and 16 +
  // 4 tig..; B (activations): row 8 nt + gid, the same k bytes; C: column
  // 16 w + gid (+ 8 for c[2], c[3]), rows 8 nt + 2 tig (+ 1 for c[1], c[3]).
  // Line l's 16-byte chunk c sits at chunk c ^ (l % 8) = c ^ gid.
  const int w = warp - 1, gid = lane >> 2, tig = lane & 3;
  Acc acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
  for (int u = u0, i = 0; u < u1; ++u, ++i) {
    const int s = i % kDecStages;
    hopper::mbar_wait(bars + 8 * s, (i / kDecStages) & 1);
    const unsigned char* wl = gbase + s * kDecStage + (16 * w + gid) * kBK + 4 * tig;
    const unsigned char* xl = gbase + s * kDecStage + kTileW + gid * kBK + 4 * tig;
    // the k-tile's four k32 products into dst
    auto ktile = [&](Acc(&dst)[NT][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = ((2 * kk) ^ gid) << 4, c1 = ((2 * kk + 1) ^ gid) << 4;
        const uint32_t a[4] = {ld32(wl + c0), ld32(wl + 8 * kBK + c0), ld32(wl + c1),
                               ld32(wl + 8 * kBK + c1)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t b[2] = {ld32(xl + nt * 8 * kBK + c0), ld32(xl + nt * 8 * kBK + c1)};
          Cd::mma(dst[nt], a, b);
        }
      }
    };
    if constexpr (Cd::kFloat) {
      // e4m3: this k-tile's sum from 0, then added into acc (promotion)
      Acc tile[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tile[nt][0] = tile[nt][1] = tile[nt][2] = tile[nt][3] = 0.f;
      ktile(tile);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += tile[nt][e];
    } else {
      ktile(acc);  // int8: exact int32 sums straight into acc
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bars + 8 * (kDecStages + s));
    if ((u + 1) % pt.nk != 0 && u + 1 != u1) continue;

    // the end of this block's piece of strip u / nk
    const int strip = u / pt.nk;
    const int np = pt.pieces(strip);
    bool last = true;
    if (np > 1) {
      constexpr int kPiece = kDecWarps * NT * 32;  // int4 a piece
      const int j = blockIdx.x - pt.blk(strip * pt.nk);
      int4* mine = p.work + (static_cast<long>(strip) * p.pieces + j) * kPiece + w * NT * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        __stcg(mine + nt * 32, make_int4(to_bits(acc[nt][0]), to_bits(acc[nt][1]),
                                         to_bits(acc[nt][2]), to_bits(acc[nt][3])));
      last = arrive_last(p.counters + strip, np, flag, threadIdx.x == 32, 32 * kDecWarps);
      if (last) {
        // int8: the other pieces added to this one's registers (exact in
        // any order); e4m3: every piece from the workspace, its own too,
        // in piece order
        if constexpr (Cd::kFloat) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
        }
        for (int jj = 0; jj < np; ++jj) {
          if (!Cd::kFloat && jj == j) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int4 v = __ldcg(mine + (jj - j) * kPiece + nt * 32);
            add_bits(acc[nt][0], v.x);
            add_bits(acc[nt][1], v.y);
            add_bits(acc[nt][2], v.z);
            add_bits(acc[nt][3], v.w);
          }
        }
      }
    }
    if (last) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * nt + 2 * tig + (e & 1);
          const int col = strip * kStrip + 16 * w + gid + 8 * (e >> 1);
          if (row < p.M)
            store1(p.y, static_cast<long>(row) * p.N + col, p.dtype,
                   rescale(acc[nt][e], p.sx[row], p.sw[col]));
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
  }
}

// One item of the prefill walk: output tile (m fastest, then n) and k split.
struct Item {
  int tile, split, m0, n0, kt0, kt1;
  __device__ Item(int it, int splits, int mt, int nk, int BM, int BN) {
    tile = it / splits;
    split = it % splits;
    m0 = (tile % mt) * BM;
    n0 = (tile / mt) * BN;
    kt0 = split * nk / splits;
    kt1 = (split + 1) * nk / splits;
  }
};

template <class Cd, int kWG, int BN>
__global__ void __launch_bounds__(128 * (kWG + 1), 1) prefill_kernel(const __grid_constant__ Params p) {
  using R = Ring<kWG, BN>;
  using Acc = typename Cd::Acc;
  constexpr int BM = R::kBM, kStages = R::kStages, kStage = R::kStage;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + R::kStagingAt + kWG * kStaging;
  volatile int* flag = reinterpret_cast<volatile int*>(smem_raw + (bars - raw) + 16 * kStages);
  const int mt = (p.M + BM - 1) / BM, nk = p.K / kBK;
  const int items = mt * ((p.N + BN - 1) / BN) * p.splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (kStages + s), 4 * kWG);  // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer warpgroup: thread 0 starts every load
    if constexpr (kWG == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int i = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item c(it, p.splits, mt, nk, BM, BN);
        for (int kt = c.kt0; kt < c.kt1; ++kt, ++i) {
          const int s = i % kStages;
          if (i >= kStages) hopper::mbar_wait(bars + 8 * (kStages + s), ((i / kStages) - 1) & 1);
          const uint32_t full = bars + 8 * s, dst = base + s * kStage;
          hopper::mbar_expect_tx(full, kStage);
          hopper::tma_load_2d(dst, &p.tm_x, full, kt * kBK, c.m0);
          hopper::tma_load_2d(dst + BM * kBK, &p.tm_w, full, kt * kBK, c.n0);
        }
      }
    }
    return;
  }
  if constexpr (kWG == 2) hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;               // this warpgroup's 64 rows of the tile
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  int i = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item c(it, p.splits, mt, nk, BM, BN);
    Acc acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
    for (int kt = c.kt0; kt < c.kt1; ++kt, ++i) {
      const int s = i % kStages;
      hopper::mbar_wait(bars + 8 * s, (i / kStages) & 1);
      const uint32_t sa = base + s * kStage + cw * 64 * kBK;
      const uint32_t sb = base + s * kStage + BM * kBK;
      hopper::wgmma_fence();
      if constexpr (Cd::kFloat) {
        // this k-tile's sum from 0 on the tensor cores, then added into
        // acc in f32 registers; the stage is free once it is read
        float tile[BN / 2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Cd::template wgmma<BN>(tile, hopper::desc_sw128(sa + 32 * j, 16, 1024),
                                 hopper::desc_sw128(sb + 32 * j, 16, 1024), j > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<BN / 2>(tile);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bars + 8 * (kStages + s));
#pragma unroll
        for (int r = 0; r < BN / 2; ++r) acc[r] += tile[r];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)  // k32 steps: 32 bytes along the swizzled line
          Cd::template wgmma<BN>(acc, hopper::desc_sw128(sa + 32 * j, 16, 1024),
                                 hopper::desc_sw128(sb + 32 * j, 16, 1024), kt > c.kt0 || j > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done: free it
        if (kt > c.kt0) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bars + 8 * (kStages + (i - 1) % kStages));
        }
      }
    }
    if constexpr (!Cd::kFloat) {
      hopper::wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bars + 8 * (kStages + (i - 1) % kStages));
    }

    bool last = true;
    if (p.splits > 1) {
      // [tile][split][warpgroup][BN / 8 groups of 4][128 threads] int4
      constexpr int kPart = BM * BN / 4;
      int4* mine = p.work + (static_cast<long>(c.tile) * p.splits + c.split) * kPart +
                   cw * (64 * BN / 4) + t;
#pragma unroll
      for (int g = 0; g < BN / 8; ++g)
        __stcg(mine + g * 128, make_int4(to_bits(acc[4 * g]), to_bits(acc[4 * g + 1]),
                                         to_bits(acc[4 * g + 2]), to_bits(acc[4 * g + 3])));
      last = arrive_last(p.counters + c.tile, p.splits, flag, threadIdx.x == 128, 128 * kWG);
      if (last && Cd::kFloat) {
        // e4m3: every split from the workspace, its own too, in split
        // order (int8 below: the others added to this one's registers)
#pragma unroll
        for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
        for (int ss = 0; ss < p.splits; ++ss) {
          const int4* o = mine + (ss - c.split) * kPart;
#pragma unroll
          for (int g = 0; g < BN / 8; ++g) {
            const int4 v = __ldcg(o + g * 128);
            add_bits(acc[4 * g], v.x);
            add_bits(acc[4 * g + 1], v.y);
            add_bits(acc[4 * g + 2], v.z);
            add_bits(acc[4 * g + 3], v.w);
          }
        }
      } else if (last) {
        for (int ss = 0; ss < p.splits; ++ss) {
          if (ss == c.split) continue;
          const int4* o = mine + (ss - c.split) * kPart;
#pragma unroll
          for (int g = 0; g < BN / 8; ++g) {
            const int4 v = __ldcg(o + g * 128);
            acc[4 * g] += v.x;
            acc[4 * g + 1] += v.y;
            acc[4 * g + 2] += v.z;
            acc[4 * g + 3] += v.w;
          }
        }
      }
    }
    if (!last) continue;
    // epilogue: rows r0 (acc[4 q], acc[4 q + 1]) and r0 + 8 (acc[4 q + 2..3]),
    // columns n0 + 8 q + 2 tig, + 1, rescaled into this warpgroup's staging
    // (boxes of 64 lines of 128 bytes, 128-byte swizzled: conflict-free
    // writes) and stored by TMA, which skips rows past M and columns past
    // N; the stores run on while the warpgroup starts the next item.  A pass
    // stages 512 bytes of each of the 64 rows (all BN columns of 16-bit
    // output, 128 of f32).
    const int rl = warp * 16 + gid;  // row within the warpgroup's 64
    const int r0 = c.m0 + cw * 64 + rl;
    const float s0 = r0 < p.M ? p.sx[r0] : 0.f, s1 = r0 + 8 < p.M ? p.sx[r0 + 8] : 0.f;
    const uint32_t stg = base + R::kStagingAt + cw * kStaging;
    unsigned char* gstg = smem_raw + (stg - raw);
    // a pass: wait until the staging's previous stores have read it, fill
    // it, then one thread stores its boxes of `box_cols` columns from col0
    auto begin = [&]() {
      if (t == 0) hopper::bulk_wait_read<0>();
      hopper::named_sync(2 + cw, 128);
    };
    auto finish = [&](int col0, int ncols, int box_cols) {
      hopper::fence_proxy_async();
      hopper::named_sync(2 + cw, 128);
      if (t == 0) {
        for (int bx = 0; bx < ncols / box_cols && col0 + bx * box_cols < p.N; ++bx)
          hopper::tma_store_2d(&p.tm_y, stg + bx * 8192, col0 + bx * box_cols, c.m0 + cw * 64);
        hopper::bulk_commit();
      }
    };
    if (p.dtype != 2) {  // 16-bit: box q / 8 of 64 columns, 4 bytes at chunk q % 8
      begin();
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = c.n0 + 8 * q + 2 * tig;
        const float w0 = col < p.N ? p.sw[col] : 0.f, w1 = col < p.N ? p.sw[col + 1] : 0.f;
        const float v0 = rescale(acc[4 * q], s0, w0), v1 = rescale(acc[4 * q + 1], s0, w1);
        const float v2 = rescale(acc[4 * q + 2], s1, w0), v3 = rescale(acc[4 * q + 3], s1, w1);
        const uint32_t lo = p.dtype == 0 ? hopper::pack2<__nv_bfloat16>(v0, v1)
                                         : hopper::pack2<__half>(v0, v1);
        const uint32_t hi = p.dtype == 0 ? hopper::pack2<__nv_bfloat16>(v2, v3)
                                         : hopper::pack2<__half>(v2, v3);
        unsigned char* line = gstg + (q >> 3) * 8192 + rl * 128 + 4 * tig;
        const int off = ((q & 7) ^ gid) << 4;
        *reinterpret_cast<uint32_t*>(line + off) = lo;
        *reinterpret_cast<uint32_t*>(line + 1024 + off) = hi;
      }
      finish(c.n0, BN, 64);
    } else {  // f32, 128 columns a pass: box qq / 4 of 32, 8 bytes in chunk 2 (qq % 4) + tig / 2
#pragma unroll
      for (int pass = 0; pass < BN / 128; ++pass) {
        begin();
#pragma unroll
        for (int qq = 0; qq < 16; ++qq) {
          const int q = pass * 16 + qq;
          const int col = c.n0 + 8 * q + 2 * tig;
          const float w0 = col < p.N ? p.sw[col] : 0.f, w1 = col < p.N ? p.sw[col + 1] : 0.f;
          const int ch = (2 * (qq & 3) + (tig >> 1)) ^ gid;
          unsigned char* line = gstg + (qq >> 2) * 8192 + rl * 128 + (ch << 4) + (tig & 1) * 8;
          *reinterpret_cast<float2*>(line) =
              make_float2(rescale(acc[4 * q], s0, w0), rescale(acc[4 * q + 1], s0, w1));
          *reinterpret_cast<float2*>(line + 1024) =
              make_float2(rescale(acc[4 * q + 2], s1, w0), rescale(acc[4 * q + 3], s1, w1));
        }
        finish(c.n0 + pass * 128, 128, 32);
      }
    }
  }
  if (t == 0) hopper::bulk_wait<0>();  // every store done before the block's memory goes
}

// The limit is raised on every launch: a function-local static would be one
// object for every library of the process that instantiates the same kernel.
template <typename Kernel>
int launch(Kernel kernel, int blocks, int threads, int smem, const Params& p, cudaStream_t stream) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class Cd, int kWG, int BN>
int launch_prefill(int blocks, const Params& p, cudaStream_t stream) {
  return launch(prefill_kernel<Cd, kWG, BN>, blocks, 128 * (kWG + 1), Ring<kWG, BN>::kSmem, p, stream);
}

// qx [M, K], qw_t [N, K] (the weight codes transposed) of Cd's code type,
// sx [M] f32, sw [N] f32, y [M, N]; all contiguous and 16-byte aligned.
// M >= 1, N and K multiples of 128.  dtype of y: 0 = bf16, 1 = fp16, 2 =
// f32.  The plan (ops/quantized_matmul.py:_qmm_plan): `blocks` (at most
// the units at M <= 16, the items above), and above M = 16 the tile width
// bn (128 or 256; e4m3 takes 128 only) and the k splits a tile (1 .. K /
// 128).  work: work_ints int32 of partials, counters: n_counters zeroed
// int32 (left zeroed); each must hold what the plan needs (else nothing
// runs and the call returns cudaErrorInvalidValue).  Returns a
// cudaError_t: 0 when the launch was accepted.
template <class Cd>
int run(const void* qx, const void* qw_t, const void* sx, const void* sw, void* y, void* work,
        void* counters, int M, int N, int K, int dtype, int blocks, int bn, int splits,
        int work_ints, int n_counters, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0 || N % 128 != 0 || K % 128 != 0 || dtype < 0 || dtype > 2 ||
      blocks <= 0)
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.y = y;
  p.work = static_cast<int4*>(work);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.N = N;
  p.K = K;
  p.dtype = dtype;
  p.splits = 1;
  p.pieces = 1;
  if (M <= 16) {
    const int nt = M <= 8 ? 1 : 2;
    const Part pt(N, K, blocks);
    if (blocks > pt.total) return bad;
    const int strips = N / kStrip;
    p.pieces = pt.max_pieces();
    const long need = p.pieces > 1 ? static_cast<long>(strips) * p.pieces * kDecWarps * nt * 32 * 4 : 0;
    if (work_ints < need || n_counters < (p.pieces > 1 ? strips : 0)) return bad;
    if (!hopper::map_2d_u8(&p.tm_w, qw_t, N, K, kStrip) ||
        !hopper::map_2d_u8(&p.tm_x, qx, M, K, 8 * nt))
      return static_cast<int>(cudaErrorNotSupported);
    const int smem = kDecStages * kDecStage + 16 * kDecStages + 16 + 1024;
    return nt == 1 ? launch(decode_kernel<Cd, 1>, blocks, kDecThreads, smem, p, s)
                   : launch(decode_kernel<Cd, 2>, blocks, kDecThreads, smem, p, s);
  }
  const int bm = M <= 64 ? 64 : 128;
  const int nk = K / kBK;
  if ((bn != 128 && bn != 256) || splits < 1 || splits > nk) return bad;
  const long tiles = static_cast<long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  if (blocks > tiles * splits) return bad;
  p.splits = splits;
  const long need = splits > 1 ? tiles * splits * bm * bn : 0;
  if (work_ints < need || n_counters < (splits > 1 ? tiles : 0)) return bad;
  if (!hopper::map_2d_u8(&p.tm_x, qx, M, K, bm) || !hopper::map_2d_u8(&p.tm_w, qw_t, N, K, bn) ||
      !hopper::map_2d_out(&p.tm_y, y, dtype, M, N, 64))
    return static_cast<int>(cudaErrorNotSupported);
  if constexpr (Cd::kFloat) {
    if (bn != 128) return bad;
    return bm == 64 ? launch_prefill<Cd, 1, 128>(blocks, p, s) : launch_prefill<Cd, 2, 128>(blocks, p, s);
  } else {
    if (bm == 64)
      return bn == 128 ? launch_prefill<Cd, 1, 128>(blocks, p, s) : launch_prefill<Cd, 1, 256>(blocks, p, s);
    return bn == 128 ? launch_prefill<Cd, 2, 128>(blocks, p, s) : launch_prefill<Cd, 2, 256>(blocks, p, s);
  }
}

}  // namespace qmm
