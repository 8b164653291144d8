// Philox4x32-10 keep bits for attention dropout in the flash kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).  The plain twin is
// ops/_philox.py; the mapping is written out there and holds here bit for
// bit:
//   element (b, h, i, j) (batch, query head, query row, key) belongs to
//   the call at counter (c0, c1, c2, c3) = ((j >> 4) * 32 + (i & 7) * 4 +
//   ((j >> 1) & 3), i >> 4, b * H + h, offset) under the key (seed low,
//   seed high), and is kept iff 16-bit field ((j & 1) * 2 + ((i >> 3) &
//   1), (j >> 3) & 1) (word, half) of the call's four words is at least
//   thr = round(p * 65536).
// So a call decides the 8 elements rows {i0, i0 + 8} x keys {j0, j0 + 1,
// j0 + 8, j0 + 9} of a 16 x 16 block (i0 < 8, j0 = 2t, t < 4), and the
// bit of an element depends on (seed, offset, b, h, i, j) alone: not on
// tile sizes, not on the thread that holds it.  A thread of an m64nNk16
// wgmma accumulator holds rows gid and gid + 8 and keys 2 tig, 2 tig + 1
// of every 8-key group: with 16-aligned tile origins, one call per two
// groups in the forward and dq kernels (rows are queries), and in the
// dk/dv kernel (rows are keys) two calls per two groups shared with the
// lane four away.
#pragma once

#include <cstdint>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;  // multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // key increments (Weyl)
constexpr uint32_t kW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., SC 2011), as curand_Philox4x32_10
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// one (b, h) pair's dropout state
struct Dropout {
  uint2 key;
  uint32_t bh, offset, thr;

  // pair: the (seed, offset) int64 pair in device memory; bh = b * H + h
  __device__ Dropout(const int64_t* pair, int bh_, uint32_t thr_)
      : bh(static_cast<uint32_t>(bh_)), thr(thr_) {
    const uint64_t seed = static_cast<uint64_t>(pair[0]);
    key = make_uint2(static_cast<uint32_t>(seed),
                     static_cast<uint32_t>(seed >> 32));
    offset = static_cast<uint32_t>(pair[1]);
  }

  // the four words of the call that element (i, j) belongs to
  __device__ __forceinline__ uint4 call(int i, int j) const {
    const uint32_t ui = static_cast<uint32_t>(i), uj = static_cast<uint32_t>(j);
    return philox4x32_10(
        make_uint4((uj >> 4) * 32u + (ui & 7u) * 4u + ((uj >> 1) & 3u),
                   ui >> 4, bh, offset),
        key);
  }

  // 1 where 16-bit field `half` of `w` is kept
  __device__ __forceinline__ uint32_t kept(uint32_t w, int half) const {
    return ((w >> (16 * half)) & 0xFFFFu) >= thr ? 1u : 0u;
  }

  // element (i, j) alone (the check entry)
  __device__ __forceinline__ bool keep(int i, int j) const {
    const uint4 w = call(i, j);
    const int word = (j & 1) * 2 + ((i >> 3) & 1);
    const uint32_t x = word == 0 ? w.x : word == 1 ? w.y : word == 2 ? w.z : w.w;
    return kept(x, (j >> 3) & 1) != 0u;
  }

  // Rows are queries (forward, dq): the call of rows (i0, i0 + 8), keys
  // (j0, j0 + 1, j0 + 8, j0 + 9) in the accumulator's element order.
  // Bit 4 g + e is element e (row e >> 1, key e & 1) of 8-key group g:
  // word (e & 1) * 2 + (e >> 1), half g.
  __device__ __forceinline__ uint32_t row_bits(uint4 w) const {
    return kept(w.x, 0) | kept(w.z, 0) << 1 | kept(w.y, 0) << 2 |
           kept(w.w, 0) << 3 | kept(w.x, 1) << 4 | kept(w.z, 1) << 5 |
           kept(w.y, 1) << 6 | kept(w.w, 1) << 7;
  }

  // Rows are keys (dk/dv): a thread's two keys share word (key & 1) * 2
  // + g of each call; a0 / a1 are words g = 0 / 1 of the call of its
  // query column 0 (query & 7 even), b0 / b1 of column 1.  Bit 4 g + e
  // is element e (key row e >> 1 = the half, query column e & 1) of
  // 8-query group g.
  __device__ __forceinline__ uint32_t col_bits(uint32_t a0, uint32_t a1,
                                               uint32_t b0,
                                               uint32_t b1) const {
    return kept(a0, 0) | kept(b0, 0) << 1 | kept(a0, 1) << 2 |
           kept(b0, 1) << 3 | kept(a1, 0) << 4 | kept(b1, 0) << 5 |
           kept(a1, 1) << 6 | kept(b1, 1) << 7;
  }
};

// Dropout where kOn, else an empty object (the kernels' p = 0 forms)
template <bool kOn>
struct MaybeDropout {
  __device__ MaybeDropout(const int64_t*, int, uint32_t) {}
};
template <>
struct MaybeDropout<true> : Dropout {
  __device__ MaybeDropout(const int64_t* pair, int bh, uint32_t thr)
      : Dropout(pair, bh, thr) {}
};

}  // namespace philox
