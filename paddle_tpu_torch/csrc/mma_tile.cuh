// Tensor-core and tile helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// mma.sync m16n8k16 with f32 accumulation; per thread of a warp (lane =
// 4 * gid + tig):
//   A (16 x 16, row major): a[0] = (row gid,     k 2*tig .. 2*tig+1)
//                           a[1] = (row gid + 8, k 2*tig .. 2*tig+1)
//                           a[2] = (row gid,     k 2*tig+8 .. 2*tig+9)
//                           a[3] = (row gid + 8, k 2*tig+8 .. 2*tig+9)
//   B (16 x 8, "col"):      b[0] = (k 2*tig .. 2*tig+1,   col gid)
//                           b[1] = (k 2*tig+8 .. 2*tig+9, col gid)
//   C (16 x 8):             c[0..1] = (row gid,     cols 2*tig, 2*tig+1)
//                           c[2..3] = (row gid + 8, cols 2*tig, 2*tig+1)
// so the C fragments of n8 tiles 2c and 2c + 1 are exactly the A fragment
// of k16 chunk c once packed to 16 bits (the lower k index in the low
// half).  Tiles live in shared memory with rows padded by 8 elements so
// the 32-bit fragment loads are bank-conflict free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

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

// A fragment of rows [row0, row0 + 16) and k columns [col0, col0 + 16) of
// a row-major shared tile with leading dimension ld (tile[row][k]).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile, int ld,
                                       int row0, int col0, int gid, int tig) {
  const T* base = tile + (row0 + gid) * ld + col0 + tig * 2;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * ld);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * ld + 8);
}

// B fragment where B[k][n] = tile[n][k] (k runs along a tile row): n rows
// [n0, n0 + 8), k columns [k0, k0 + 16).  Used for q k^T-shaped products.
template <typename T>
__device__ __forceinline__ void load_b_rows(uint32_t* b, const T* tile, int ld,
                                            int n0, int k0, int gid, int tig) {
  const T* base = tile + (n0 + gid) * ld + k0 + tig * 2;
  b[0] = ld32(base);
  b[1] = ld32(base + 8);
}

// B fragment where B[k][n] = tile[k][n] (k runs down the tile's rows): k
// rows [k0, k0 + 16), n columns [n0, n0 + 8).  Used for p v-shaped
// products.
template <typename T>
__device__ __forceinline__ void load_b_cols(uint32_t* b, const T* tile, int ld,
                                            int k0, int n0, int gid, int tig) {
  const T* base = tile + (k0 + tig * 2) * ld + n0 + gid;
  b[0] = ld16(base) | (ld16(base + ld) << 16);
  b[1] = ld16(base + 8 * ld) | (ld16(base + 9 * ld) << 16);
}

// Copy 64 rows of D elements (row stride `stride` elements in global
// memory) into shared memory rows of `ld` elements, kThreads threads
// cooperating with 16-byte vectors; rows at or past `valid` are
// zero-filled.
template <typename T, int D, int kThreads>
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

}  // namespace flash
