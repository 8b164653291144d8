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
// to the weight type, f32 accumulation, f32 bias; attention scores and
// softmax in f32 from q and the cached k/v in the weight type (int8 codes
// dequantized to it), p rounded to it for p v, the new token in f32; tanh
// GELU in f32; x_out = (x2 + mlp) + b_down rounded to x's type.
//
// What bounds it: the bytes (the layer's weights once for all slots, each
// slot's cached k/v once).  Design: one cooperative launch per layer step,
// one block of 288 threads per SM (the grid is the SM count), five phases:
//   1 qkv = LN1(x) . W_qkv   (each block recomputes LN1's row statistics)
//   2 attention: (slot, kv head, 16 query heads, position part) items
//   3 o = attn . W_out; the last block done with a 64-column strip adds
//     b_out and x (x2) and that strip's LN2 row statistics
//   4 u = LN2(x2) . W_up     (each block merges the strips' statistics);
//     the last block done with a strip writes gelu(u + b_up) in T
//   5 mlp = gelu(u + b_up) . W_down; the last block done with a strip
//     writes x_out = (x2 + mlp) + b_down
// separated by four grid barriers among the consumer warps.
// - One producer warp keeps a ring of 8 stages of 8 KB full by TMA on
//   mbarriers, in the order the consumers use them, across every phase: a
//   64 x 64 weight tile, or the K and V rows of 16-64 cached positions of
//   one kv head (int8: and their f32 scales by cp.async).  It never waits
//   at a grid barrier, so the next phase's first stages load while the
//   consumers finish a phase (weights and cache are read-only).
// - Eight consumer warps run mma.sync m16n8k16 on the 16 activation rows
//   (B <= 16; zero-cost padding rows): in a product every warp takes 8
//   output columns of each weight tile, with the activation chunk in
//   shared memory; in the attention each stage goes to one warp, which
//   keeps its own online softmax (the verify window's consumer warps,
//   window_attention.cuh vq::Warp16).  A warp frees a stage with one
//   mbarrier arrival (the producer arrives for the warps that skip an
//   attention stage).
// - The products' (64-column strip x 64-row k-tile) tiles are split into
//   one contiguous run a block, so every block streams the same bytes to
//   one tile (Part below, mirrored by ops/decode_megakernel.py:_partition);
//   a run is cut at strip and at chunk (at most kMaxChunk rows) edges, and
//   each piece writes an f32 partial that the reading phase sums over the
//   blocks of its chunk in block order.  Attention items are the (slot,
//   kv head, query-head tile) pairs times a position split that fills the
//   SMs at small B; an unsplit item folds the new token in and writes its
//   rows of the attention output, split ones leave partial (m, l, acc)
//   rows that the out product's activation fill merges, with the new
//   token, in part order.  Every sum runs in a fixed order, so results do
//   not depend on scheduling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_attention.cuh"
#include "hopper_tile.cuh"
#include "window_attention.cuh"

// timing hooks of flash_fwd_variants.py (empty here): a stamp at each
// phase boundary, phases skipped by bit (producer and consumers alike),
// the grid barriers dropped
#ifndef MEGA_STAMP
#define MEGA_STAMP(i)
#endif
#ifndef MEGA_SKIP
#define MEGA_SKIP 0
#endif
#ifndef MEGA_GRID_SYNC
#define MEGA_GRID_SYNC 1
#endif

namespace mega {

using flash::kNeg;
using flash::Mma;

constexpr int kCons = 8;                    // consumer warps
constexpr int kThreads = 32 * (kCons + 1);  // + the producer warp
constexpr int kRows = 16;                   // activation rows: slots, padding past B
constexpr int kStrip = 64;                  // output columns of a weight tile
constexpr int kTileK = 64;                  // input rows of a weight tile
constexpr int kTileBytes = kStrip * kTileK * 2;  // what TMA brings a stage
constexpr int kStageBytes = kTileBytes + 1024;   // + int8 scales, 1024-aligned
constexpr int kStages = 8;
constexpr int kMaxChunk = 2048;             // activation rows staged at once
constexpr int kLdA = kMaxChunk + 8;         // padded activation row (elements)
constexpr int kWorkInts = 2 + 16384;        // the workspace (ops/decode_megakernel.py)


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

// The split of one product's tiles over the grid.  Tile t (t < total) is
// k-tile t % nk of strip t / nk; block b takes tiles [start(b), start(b +
// 1)), so the blocks' byte counts differ by one tile at most.  Chunk c is
// tiles [c cl, c cl + cl): cl divides nk and cl * 64 <= kMaxChunk, so a
// chunk lies in one strip and its activation rows fit shared memory.  The
// piece of block b in chunk c writes partial j = b - blk(c cl) of the
// chunk, P partials a chunk at most.  (32-bit: total * G < 2^31, checked
// at the launch.)
struct Part {
  int K, N, G, nk, cl, P, total;

  __host__ __device__ Part() {}
  __host__ __device__ Part(int K_, int N_, int G_) : K(K_), N(N_), G(G_), P(0) {
    nk = K / kTileK;
    cl = 1;
    for (int d = 1; d <= nk && d * kTileK <= kMaxChunk; ++d)
      if (nk % d == 0) cl = d;
    total = (N / kStrip) * nk;
  }
  __host__ __device__ int start(int b) const { return b * total / G; }
  // the block whose run holds tile t
  __host__ __device__ int blk(int t) const { return ((t + 1) * G - 1) / total; }
  __host__ __device__ int chunks() const { return total / cl; }
  __host__ int max_parts() const {
    int m = 1;
    for (int c = 0; c < chunks(); ++c) {
      const int n = blk(c * cl + cl - 1) - blk(c * cl) + 1;
      m = n > m ? n : m;
    }
    return m;
  }
  // floats of the partials: [chunk][P][B][64]
  __host__ __device__ long floats(int B) const { return static_cast<long>(chunks()) * P * B * kStrip; }
};

// the partials of one strip a reader sums, at most: chunks a strip x P
constexpr int kMaxStripParts = 32;
// strips a table holds (an activation chunk's, or 16 query heads' and
// their kv head's k and v)
constexpr int kTabStrips = kMaxChunk / kStrip + 8;

template <typename T, typename KV>
struct Params {
  CUtensorMap tm_qkv, tm_out, tm_up, tm_down;  // weights [in, out]: 64 x 64 boxes
  CUtensorMap tm_k, tm_v;                      // the cache, boxes of `seg` positions
  const T* x;
  const T* ln1_w;
  const T* ln1_b;
  const T* b_qkv;
  const T* b_out;
  const T* ln2_w;
  const T* ln2_b;
  const T* b_up;
  const T* b_down;
  const float* ks;     // int8 only: [B, cap, Hkv] dense, [NB, bs, Hkv] paged
  const float* vs;
  const int* tables;   // paged only: [B, MB]
  const int* lengths;  // [B], tokens cached before the new one
  T* x_out;            // [B, H]
  T* k_new;            // [B, Hkv, D]
  T* v_new;
  float* scratch;
  unsigned* work;      // [kWorkInts], zero when first used (the barrier word stays consistent)
  Part pq, po, pu, pd;
  int B, H, Hkv, G, F, cap, bs, MB, seg, RT, NP;
  float eps, scale_log2;  // 1 / sqrt(D) * log2(e)
};

// the workspace: the grid barrier's word, alone on its 128-byte line, then
// the strip counters of the out, up and down products, one run each
constexpr int kStripCounters = 32;

// scratch offsets in floats, each area on a 256-byte boundary
struct Layout {
  long qkv, attn, ml, snew, vn, ao, out, x2, st2, up, act, down, total;
  static __host__ __device__ long up64(long n) { return (n + 63) / 64 * 64; }
  __host__ __device__ Layout(int B, int H, int Hkv, int D, int F, int RT, int NP, const Part& pq,
                             const Part& po, const Part& pu, const Part& pd) {
    const long items = static_cast<long>(B) * Hkv * RT * NP;
    qkv = 0;
    attn = up64(qkv + pq.floats(B));                         // [item][16][D]: acc
    ml = up64(attn + items * kRows * D);                     // [item][16][2]: m, l
    snew = up64(ml + items * kRows * 2);                     // [B, heads]
    vn = up64(snew + static_cast<long>(B) * (H / D));        // [B, Hkv, D]
    ao = up64(vn + static_cast<long>(B) * Hkv * D);          // [B, H] in T: the attention output
    out = up64(ao + static_cast<long>(B) * H / 2);
    x2 = up64(out + po.floats(B));                           // [B, H]
    st2 = up64(x2 + static_cast<long>(B) * H);               // [strip][B][mean, M2]
    up = up64(st2 + static_cast<long>(H / kStrip) * B * 2);
    act = up64(up + pu.floats(B));                           // [B, F] in T: gelu(u + b_up)
    down = up64(act + static_cast<long>(B) * F / 2);
    total = up64(down + pd.floats(B));
  }
};

// byte offsets from the 1024-aligned base of dynamic shared memory
template <typename T, int D>
struct Smem {
  static constexpr int kRing = kStages * kStageBytes;
  // the activation chunk of a product, or an attention item's Q rows, its
  // q, k, v in f32 and its warps' (m, l, acc) for the merge
  static constexpr int kA = kRows * kLdA * 2;
  static constexpr int kQLd = D + 8;
  static constexpr int kAccLd = D + 4;
  static constexpr int kAttn = kRows * kQLd * 2 + kCons * kRows * (2 + kAccLd) * 4;
  static constexpr int kRegion = kA > kAttn ? kA : kAttn;
  static constexpr int kStats = kRing + kRegion;  // mu, rstd of 16 rows twice; a flag
  static constexpr int kTab = kStats + 4 * kRows * 4 + 16;  // partial offsets by strip
  // an attention item's new-token scores (16 rows) and v as attended
  static constexpr int kItem = kTab + kTabStrips * (1 + kMaxStripParts) * 4;
  static constexpr int kBars = kItem + (kRows + D) * 4;
  static constexpr int kTbl = kBars + 2 * kStages * 8;  // the producer's block table
  static constexpr int kLaunch = kTbl + 1024;           // + alignment slack
};

// barrier among the consumer warps
__device__ __forceinline__ void cons_sync() { hopper::named_sync(1, kCons * 32); }

// Grid-wide barrier among the consumer warps of every block (the producer
// warps run on), on one word: block 0 adds 2^31 - (blocks - 1), the others
// 1, so the word's top bit flips once every block has arrived and its low
// bits are back where they were, for the next barrier and launch.  The
// arrival is a release and the wait an acquire (after and before a block
// barrier), so every write before it is visible to every block after it;
// no full fence, which would also wait for the producer's loads in flight.
__device__ __forceinline__ void grid_sync(unsigned* word) {
  cons_sync();
  if (MEGA_GRID_SYNC && threadIdx.x == 0) {
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, now;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(word), "r"(inc) : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(word) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  cons_sync();
}

// two 16-bit values of one word as f32 (the low half first)
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// 8 consecutive 16-bit values (16 bytes) as f32, and back
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack2<T>(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(hopper::pack2<T>(v[0], v[1]), hopper::pack2<T>(v[2], v[3]),
                                            hopper::pack2<T>(v[4], v[5]), hopper::pack2<T>(v[6], v[7]));
}
// 8 consecutive 16-bit values another block wrote during this launch
template <typename T>
__device__ __forceinline__ void load8_cg(const T* p, float* v) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack2<T>(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// 8 consecutive f32 another block wrote during this launch
__device__ __forceinline__ void ld8_cg(const float* p, float* v) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T, typename KV, int D, bool kPaged>
struct Kernel {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // an attention tile: kTilePos positions of one kv head, one 8 KB TMA box
  // a ring slot (K boxes, then V boxes; a 16-bit D = 128 row is two boxes
  // of 64 columns), kGroups warps taking 16 positions each
  static constexpr int kLine = kQuant ? D : 128;     // bytes of a box line
  static constexpr int kBoxes = kQuant ? 1 : D / 64;
  static constexpr int kTilePos = kTileBytes / kLine;
  static constexpr int kTileSlots = 2 * kBoxes;
  static constexpr int kGroups = kTilePos / 16;
  static_assert(kGroups <= kCons && kCons % kGroups == 0, "groups of a tile");
  static constexpr int kSegs = kTilePos / 16;        // pool segments a tile, at most
  static constexpr int kPer = (kTilePos + 30) / 31;  // scales a producer lane, at most
  // tile T + kStages / kTileSlots reuses tile T's slots; it must go to the
  // warps that used them last, or a warp could wait on a slot two
  // mbarrier phases early (its parity would pass on the older phase)
  static_assert(kStages % kTileSlots == 0 && (kStages / kTileSlots) % (kCons / kGroups) == 0,
                "attention tile owners and ring depth");
  using S = Smem<T, D>;
  using W16 = window_attn::vq::Warp16<T, KV, D>;

  const Params<T, KV>& p;
  unsigned char* sm;  // 1024-aligned
  uint32_t base;
  const Layout lay;
  const int warp, lane;

  __device__ Kernel(const Params<T, KV>& prm, unsigned char* s, uint32_t b)
      : p(prm), sm(s), base(b),
        lay(prm.B, prm.H, prm.Hkv, D, prm.F, prm.RT, prm.NP, prm.pq, prm.po, prm.pu, prm.pd),
        warp(threadIdx.x >> 5), lane(threadIdx.x & 31) {}

  __device__ uint32_t stage(uint32_t i) const { return base + (i % kStages) * kStageBytes; }
  __device__ uint32_t full(uint32_t i) const { return base + S::kBars + 8 * (i % kStages); }
  __device__ uint32_t empty(uint32_t i) const { return base + S::kBars + 8 * (kStages + i % kStages); }
  __device__ uint32_t parity(uint32_t i) const { return (i / kStages) & 1; }
  __device__ float* stats() const { return reinterpret_cast<float*>(sm + S::kStats); }
  __device__ int* tab() const { return reinterpret_cast<int*>(sm + S::kTab); }
  // the strip counters of epilogue 1 (out), 3 (up) or 2 (down); every
  // launch zeroes them in phase 1, before their first use
  __device__ unsigned* counters(int epi) const {
    const int h = p.H / kStrip;
    return p.work + kStripCounters + (epi == 1 ? 0 : epi == 3 ? h : h + p.F / kStrip);
  }

  // ---- attention items ----------------------------------------------------
  __device__ int n_items() const { return p.B * p.Hkv * p.RT * p.NP; }
  struct Item {
    int b, hk, rt, part, L, u0, u1, rows;
  };
  __device__ Item item(int i) const {
    Item it;
    it.part = i % p.NP;
    int r = i / p.NP;
    it.rt = r % p.RT;
    r /= p.RT;
    it.hk = r % p.Hkv;
    it.b = r / p.Hkv;
    const int len = max(p.lengths[it.b], 0);
    it.L = kPaged ? min(len, p.MB * p.bs) : min(len, p.cap - 1);
    const int nt = (it.L + kTilePos - 1) / kTilePos;
    it.u0 = it.part * nt / p.NP;
    it.u1 = (it.part + 1) * nt / p.NP;
    it.rows = min(kRows, p.G - kRows * it.rt);
    return it;
  }

  // ---- the producer ---------------------------------------------------------
  __device__ void wait_slot(uint32_t i) const {
    if (i >= kStages) hopper::mbar_wait(empty(i), parity(i) ^ 1);
  }

  __device__ void produce_product(const Part& pt, const CUtensorMap* map, uint32_t& i) const {
    const int t1 = pt.start(blockIdx.x + 1);
    for (int t = pt.start(blockIdx.x); t < t1; ++t, ++i) {
      wait_slot(i);
      if (lane == 0) {
        hopper::mbar_expect_tx(full(i), kTileBytes);
        const int s = t / pt.nk;
        hopper::tma_load_2d(stage(i), map, full(i), s * kStrip, (t - s * pt.nk) * kTileK);
      } else {
        hopper::mbar_arrive(full(i));
      }
    }
  }

  __device__ void produce_attention(uint32_t& i) const {
    int* tbl = reinterpret_cast<int*>(sm + S::kTbl);
    for (int n = blockIdx.x; n < n_items(); n += gridDim.x) {
      const Item it = item(n);
      const int n_blk = kPaged ? (it.L + p.bs - 1) / p.bs : 0;
      if constexpr (kPaged) {
        __syncwarp();
        for (int j = lane; j < n_blk; j += 32) tbl[j] = p.tables[static_cast<long>(it.b) * p.MB + j];
        __syncwarp();
      }
      for (int u = it.u0; u < it.u1; ++u) {
        const int pos0 = u * kTilePos;
        // the tile's plan, worked out before its slots are waited for:
        // lane g walks the table for pool segment g (blocks and offsets
        // to every lane by shuffle); each scale lane's rows by shuffle
        int sblk[kSegs], soff[kSegs];
        long srow[kPer];
        const int lg = __ffs(p.seg) - 1;
        if constexpr (kPaged) {
          int blk = 0, off = 0;
          if (lane < (kTilePos >> lg)) {
            const int t = pos0 + (lane << lg);
            const int bi = t / p.bs;
            blk = bi < n_blk ? tbl[bi] : 0;  // the null block past them
            off = t - bi * p.bs;
          }
#pragma unroll
          for (int g = 0; g < kSegs; ++g) {
            sblk[g] = __shfl_sync(0xffffffffu, blk, g);
            soff[g] = __shfl_sync(0xffffffffu, off, g);
          }
          if constexpr (kQuant) {
            const long seg_row = static_cast<long>(blk) * p.bs + off;
#pragma unroll
            for (int v = 0; v < kPer; ++v) {
              const int q = (lane - 1 + 31 * v) & (kTilePos - 1);
              srow[v] = __shfl_sync(0xffffffffu, seg_row, q >> lg) + (q & (p.seg - 1));
            }
          }
        } else if constexpr (kQuant) {
#pragma unroll
          for (int v = 0; v < kPer; ++v) srow[v] = static_cast<long>(it.b) * p.cap + pos0 + lane - 1 + 31 * v;
        }
        for (int j = 0; j < kTileSlots; ++j, ++i) {
          const bool isv = j >= kBoxes;
          const int c = isv ? j - kBoxes : j;
          const CUtensorMap* map = isv ? &p.tm_v : &p.tm_k;
          wait_slot(i);
          const uint32_t st = stage(i);
          if (lane == 0) {
            hopper::mbar_expect_tx(full(i), kTileBytes);
            if constexpr (kPaged) {
#pragma unroll
              for (int g = 0; g < kSegs; ++g)
                if (g < (kTilePos >> lg))
                  hopper::tma_load_4d(st + (g << lg) * kLine, map, full(i), c * 64, it.hk, soff[g], sblk[g]);
            } else {
              hopper::tma_load_4d(st, map, full(i), c * 64, it.hk, pos0, it.b);
            }
            // the warps that skip this tile free the slot at once
            if (kGroups < kCons) hopper::mbar_arrive_cnt(empty(i), kCons - kGroups);
          } else if constexpr (kQuant) {
            // this tensor's scales of the tile's positions, zero past the
            // capacity
            const float* scl = isv ? p.vs : p.ks;
#pragma unroll
            for (int v = 0; v < kPer; ++v) {
              const int q = lane - 1 + 31 * v;
              const bool live = kPaged || pos0 + q < p.cap;
              if (q < kTilePos)
                window_attn::vq::cp_async4(st + kTileBytes + 4 * q, live ? scl + srow[v] * p.Hkv + it.hk : scl,
                                           live);
            }
            window_attn::vq::cp_async_arrive(full(i));
          } else {
            hopper::mbar_arrive(full(i));
          }
        }
      }
    }
  }

  __device__ void produce() const {
    uint32_t i = 0;
    if (!(MEGA_SKIP & 1)) produce_product(p.pq, &p.tm_qkv, i);
    if (!(MEGA_SKIP & 2)) produce_attention(i);
    if (!(MEGA_SKIP & 4)) produce_product(p.po, &p.tm_out, i);
    if (!(MEGA_SKIP & 8)) produce_product(p.pu, &p.tm_up, i);
    if (!(MEGA_SKIP & 16)) produce_product(p.pd, &p.tm_down, i);
  }

  // ---- partial sums ---------------------------------------------------------
  // The table of up to three runs of strips of product pt (run r: strips
  // s0[r] .. s0[r] + ns[r] - 1, listed one run after the other, at most
  // kTabStrips together): for each, how many partials and their offsets
  // (floats, row 0, column 0), chunk by chunk, block by block: the fixed
  // summation order.  Consumers only; the table is ready after it returns.
  __device__ void build_tab(const Part& pt, const int* s0, const int* ns, int runs) const {
    int* t = tab();
    cons_sync();  // the previous table has been read
    const int per = pt.nk / pt.cl;
    const int total = ns[0] + (runs > 1 ? ns[1] : 0) + (runs > 2 ? ns[2] : 0);
    for (int i = threadIdx.x; i < total; i += kCons * 32) {
      const int r = i < ns[0] ? 0 : i < ns[0] + ns[1] ? 1 : 2;
      const int s = s0[r] + i - (r > 0 ? ns[0] : 0) - (r > 1 ? ns[1] : 0);
      int n = 0;
      for (int kc = 0; kc < per; ++kc) {
        const int c = s * per + kc;
        const int b0 = pt.blk(c * pt.cl);
        const int b1 = pt.blk(c * pt.cl + pt.cl - 1);
        for (int bb = b0; bb <= b1; ++bb)
          if (pt.start(bb) < pt.start(bb + 1))  // runs may be empty when tiles < blocks
            t[kTabStrips + i * kMaxStripParts + n++] = (c * pt.P + (bb - b0)) * p.B * kStrip;
      }
      t[i] = n;
    }
    cons_sync();
  }
  __device__ void build_tab(const Part& pt, int s0, int ns) const { build_tab(pt, &s0, &ns, 1); }

  // 8 consecutive columns (col % 8 == 0) of table strip i, row b: the sum
  // of the strip's partials, in table order
  __device__ void tab_sum8(const float* part, int i, int b, int col, float* v) const {
    const int* t = tab();
    const int n = t[i];
    const int* off = t + kTabStrips + i * kMaxStripParts;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    int j = 0;
    for (; j + 1 < n; j += 2) {
      float a[8], c[8];
      ld8_cg(part + off[j] + b * kStrip + col, a);
      ld8_cg(part + off[j + 1] + b * kStrip + col, c);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] + a[e]) + c[e];
    }
    if (j < n) {
      float a[8];
      ld8_cg(part + off[j] + b * kStrip + col, a);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += a[e];
    }
  }

  // ---- the consumers: products ---------------------------------------------
  // activation rows [r0, r0 + len) (multiples of 64) of phase `ph` into the
  // chunk buffer, 8 values a thread a step
  __device__ void fill(int ph, int r0, int len) const {
    const int B = p.B;
    T* a = reinterpret_cast<T*>(sm + S::kRing);
    const float* st = stats();
    const int n8 = len / 8;
    const T* ao = reinterpret_cast<const T*>(p.scratch + lay.ao);
    const T* act = reinterpret_cast<const T*>(p.scratch + lay.act);
#pragma unroll 2
    for (int e = threadIdx.x; e < B * n8; e += kCons * 32) {
      const int b = e / n8;
      const int k = r0 + (e - b * n8) * 8;
      float v[8];
      if (ph == 0) {
        float x[8], w[8], bb[8];
        load8(p.x + static_cast<long>(b) * p.H + k, x);
        load8(p.ln1_w + k, w);
        load8(p.ln1_b + k, bb);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = (x[i] - st[b]) * st[kRows + b] * w[i] + bb[i];
      } else if (ph == 2) {
        // the attention output: final from its item, or merged here from
        // the position parts' partials
        if (p.NP == 1)
          load8_cg(ao + static_cast<long>(b) * p.H + k, v);
        else
          attn_out8(b, k, v);
      } else if (ph == 3) {
        float x2[8], w[8], bb[8];
        ld8_cg(p.scratch + lay.x2 + static_cast<long>(b) * p.H + k, x2);
        load8(p.ln2_w + k, w);
        load8(p.ln2_b + k, bb);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = (x2[i] - st[2 * kRows + b]) * st[3 * kRows + b] * w[i] + bb[i];
      } else {
        load8_cg(act + static_cast<long>(b) * p.F + k, v);
      }
      store8(a + b * kLdA + (k - r0), v);
    }
  }

  // attention output columns k .. k + 7 (one head h, columns d .. d + 7)
  // of slot b: the items' partials of (b, h) merged in part order with the
  // new token, normalized
  __device__ void attn_out8(int b, int k, float* v) const {
    const int h = k / D;
    const int d = k - h * D;
    const int hk = h / p.G;
    const int g = h - hk * p.G;
    const int rt = g / kRows;
    const int r = g - rt * kRows;
    const float s_new = __ldcg(p.scratch + lay.snew + static_cast<long>(b) * (p.H / D) + h);
    const long first = ((static_cast<long>(b) * p.Hkv + hk) * p.RT + rt) * p.NP;
    float mx = s_new;
    for (int q = 0; q < p.NP; ++q)
      mx = fmaxf(mx, __ldcg(p.scratch + lay.ml + ((first + q) * kRows + r) * 2));
    const float f_new = hopper::ex2(s_new - mx);
    float den = f_new;
    float vn[8];
    ld8_cg(p.scratch + lay.vn + (static_cast<long>(b) * p.Hkv + hk) * D + d, vn);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = f_new * vn[e];
    for (int q = 0; q < p.NP; ++q) {
      const long row = (first + q) * kRows + r;
      const float f = hopper::ex2(__ldcg(p.scratch + lay.ml + row * 2) - mx);
      den += __ldcg(p.scratch + lay.ml + row * 2 + 1) * f;
      float acc[8];
      ld8_cg(p.scratch + lay.attn + row * D + d, acc);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += acc[e] * f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] /= den;
  }

  // one product phase; `ph` picks the fill, epi the strip epilogue
  __device__ void consume_product(const Part& pt, int ph, float* part, int epi, uint32_t& i) const {
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int B = p.B;
    const uint32_t a_base = base + S::kRing;
    int t = pt.start(blockIdx.x);
    const int t1 = pt.start(blockIdx.x + 1);
    while (t < t1) {
      const int c = t / pt.cl;
      const int te = min(t1, (c + 1) * pt.cl);  // this piece: [t, te)
      const int s = t / pt.nk;
      const int kt0 = t - s * pt.nk;
      cons_sync();  // the previous piece is done with the activation chunk
      fill(ph, kt0 * kTileK, (te - t) * kTileK);
      cons_sync();
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int u = t; u < te; ++u, ++i) {
        hopper::mbar_wait(full(i), parity(i));
        const uint32_t tile = stage(i);
        const int acol = (u - t) * kTileK;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          // B: k rows 32 jj + lane of the tile, 8 columns of this warp
          uint32_t bw[4];
          const int row = 32 * jj + lane;
          window_attn::vq::ldsm_x4_t(bw, tile + row * 128 + ((warp ^ (row & 7)) << 4));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a[4];
            window_attn::vq::ldsm_x4(
                a, a_base + ((lane & 15) * kLdA + acol + 16 * (2 * jj + h) + ((lane >> 4) << 3)) * 2);
            const uint32_t bf[2] = {bw[2 * h], bw[2 * h + 1]};
            Mma<T>::run(acc, a, bf);
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty(i));
      }
      // this piece's partial: partial j of chunk c
      const int j = blockIdx.x - pt.blk(c * pt.cl);
      float* dst = part + (static_cast<long>(c * pt.P + j) * B) * kStrip + 8 * warp + 2 * tig;
      if (gid < B) *reinterpret_cast<float2*>(dst + gid * kStrip) = make_float2(acc[0], acc[1]);
      if (gid + 8 < B) *reinterpret_cast<float2*>(dst + (gid + 8) * kStrip) = make_float2(acc[2], acc[3]);
      if (epi) strip_done(pt, part, s, epi);
      t = te;
    }
  }

  // after a piece of strip s: the block that completes the strip runs its
  // epilogue (1: x2 and its LN2 statistics; 2: x_out; 3: gelu(u + b_up))
  __device__ void strip_done(const Part& pt, const float* part, int s, int epi) const {
    build_tab(pt, s, 1);  // (its block barriers order every warp's partial first)
    int* flag = reinterpret_cast<int*>(stats() + 4 * kRows);
    unsigned* cnt = counters(epi) + s;
    if (threadIdx.x == 0) {
      // release this block's partial, acquire the others' when last
      unsigned done;
      asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(done) : "l"(cnt) : "memory");
      *flag = done + 1 == static_cast<unsigned>(tab()[0]);
    }
    cons_sync();
    if (!*flag) return;
    const int B = p.B;
    // 8 columns a thread: row e / 8, columns 8 (e % 8) .. of the strip;
    // a row's 8 threads are neighbouring lanes
    const int e = threadIdx.x;
    const int b = e >> 3;
    const int c8 = 8 * (e & 7);
    const int n = s * kStrip + c8;
    float v[8], sum[8], bias[8];
    float mean_part = 0.f;
    if (b < B) {
      tab_sum8(part, 0, b, c8, sum);
      if (epi == 1) {
        float x[8];
        load8(p.x + static_cast<long>(b) * p.H + n, x);
        load8(p.b_out + n, bias);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = x[i] + (sum[i] + bias[i]);
        float* x2 = p.scratch + lay.x2 + static_cast<long>(b) * p.H + n;
        *reinterpret_cast<float4*>(x2) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(x2 + 4) = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
        for (int i = 0; i < 8; ++i) mean_part += v[i];
      } else if (epi == 2) {
        float x2[8];
        ld8_cg(p.scratch + lay.x2 + static_cast<long>(b) * p.H + n, x2);
        load8(p.b_down + n, bias);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = (x2[i] + sum[i]) + bias[i];
        store8(p.x_out + static_cast<long>(b) * p.H + n, v);
      } else {
        load8(p.b_up + n, bias);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = gelu_tanh(sum[i] + bias[i]);
        store8(reinterpret_cast<T*>(p.scratch + lay.act) + static_cast<long>(b) * p.F + n, v);
      }
    }
    if (epi == 1 && e < kRows * 8) {
      // the strip's mean and squared deviations of each row, over its 8
      // threads
      float m = mean_part;
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) m += __shfl_xor_sync(0xffffffffu, m, off);
      m /= kStrip;
      float m2 = 0.f;
      if (b < B) {
#pragma unroll
        for (int i = 0; i < 8; ++i) m2 += (v[i] - m) * (v[i] - m);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, off);
      if (b < B && (e & 7) == 0) {
        float* st = p.scratch + lay.st2 + (static_cast<long>(s) * B + b) * 2;
        st[0] = m;
        st[1] = m2;
      }
    }
  }

  // ---- the consumers: attention ----------------------------------------------
  // an attention item's q rows (heads h0 .. h0 + rows - 1) and, with kv,
  // its kv head's new k and v: the qkv product's columns for slot b, with
  // the bias, in f32 into q[rows][D] and kv[2][D], through one table
  __device__ void item_cols(int b, int h0, int rows, int hk, bool kv, float* q, float* knv) const {
    const int nq = rows * D;
    const int n0[3] = {h0 * D, p.H + hk * D, p.H + p.Hkv * D + hk * D};
    const int s0[3] = {n0[0] / kStrip, n0[1] / kStrip, n0[2] / kStrip};
    const int ns[3] = {(n0[0] + nq - 1) / kStrip - s0[0] + 1, D / kStrip, D / kStrip};
    build_tab(p.pq, s0, ns, kv ? 3 : 1);
    const int n8 = (nq + (kv ? 2 * D : 0)) / 8;
    for (int e = threadIdx.x; e < n8; e += kCons * 32) {
      int r = 0, x = 8 * e;  // run, column within the run
      if (x >= nq) {
        r = 1 + (x - nq) / D;
        x = (x - nq) % D;
      }
      const int n = n0[r] + x;
      const int strip = n / kStrip - s0[r] + (r > 0 ? ns[0] : 0) + (r > 1 ? ns[1] : 0);
      float v[8], bias[8];
      tab_sum8(p.scratch + lay.qkv, strip, b, n % kStrip, v);
      load8(p.b_qkv + n, bias);
      float* dst = r == 0 ? q + x : knv + (r - 1) * D + x;
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = v[i] + bias[i];
    }
    cons_sync();
  }

  __device__ void consume_attention(uint32_t& i) const {
    const int ct = threadIdx.x;
    const int cw = warp;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int heads = p.H / D;
    T* sQ = reinterpret_cast<T*>(sm + S::kRing);
    float* s_m = reinterpret_cast<float*>(sm + S::kRing + kRows * S::kQLd * 2);
    float* s_l = s_m + kCons * kRows;
    float* s_acc = s_l + kCons * kRows;  // [kCons][16][kAccLd], fragment columns
    // until the key loop: the item's q rows, then the new k and v, in f32
    float* qf = s_acc;
    float* kvn = s_acc + kRows * D;
    float* isn = reinterpret_cast<float*>(sm + S::kItem);  // [16] new-token scores
    float* ivn = isn + kRows;                              // [D] its v as attended
    for (int n = blockIdx.x; n < n_items(); n += gridDim.x) {
      const Item it = item(n);
      const int h0 = it.hk * p.G + kRows * it.rt;  // the item's first query head
      item_cols(it.b, h0, it.rows, it.hk, it.part == 0, qf, kvn);
      for (int e = ct; e < kRows * D; e += kCons * 32) {
        const int r = e / D;
        sQ[r * S::kQLd + e - r * D] = decode_attn::from_float<T>(r < it.rows ? qf[e] : 0.f);
      }
      if (it.part == 0) {
        // the new token's k and v: raw out to the caller (first row tile),
        // as attended (int8: the round trip) for the scores and the merge
        if (it.rt == 0) {
          for (int d = ct; d < D; d += kCons * 32) {
            const long o = (static_cast<long>(it.b) * p.Hkv + it.hk) * D + d;
            p.k_new[o] = decode_attn::from_float<T>(kvn[d]);
            p.v_new[o] = decode_attn::from_float<T>(kvn[D + d]);
          }
          cons_sync();
        }
        if constexpr (kQuant) {
          // the composed path stores the new k/v as int8 and attends the
          // codes: the same round trip (amax / 127 scale, round half to
          // even, clip)
          if (cw < 2) {
            float* vec = kvn + cw * D;
            float amax = 0.f;
            for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(vec[d]));
            amax = warp_max(amax);
            const float sc = fmaxf(amax, 1e-8f) / 127.f;
            for (int d = lane; d < D; d += 32) vec[d] = fminf(fmaxf(rintf(vec[d] / sc), -127.f), 127.f) * sc;
          }
          cons_sync();
        }
        // the new token's score of each row, from q in f32, and its v:
        // kept for this item's final output, or stored for the merge of
        // the position parts
        for (int r = cw; r < it.rows; r += kCons) {
          float sdot = 0.f;
          for (int d = lane; d < D; d += 32) sdot = fmaf(qf[r * D + d], kvn[d], sdot);
          sdot = warp_sum(sdot);
          if (lane == 0) {
            isn[r] = sdot * p.scale_log2;
            p.scratch[lay.snew + static_cast<long>(it.b) * heads + h0 + r] = sdot * p.scale_log2;
          }
        }
        for (int d = ct; d < D; d += kCons * 32) {
          ivn[d] = kvn[D + d];
          if (it.rt == 0) p.scratch[lay.vn + (static_cast<long>(it.b) * p.Hkv + it.hk) * D + d] = kvn[D + d];
        }
      }
      cons_sync();
      W16 w16;
      w16.init(sQ, S::kQLd, lane);
      const int lim[2] = {it.L - 1, it.L - 1};
      for (int u = it.u0; u < it.u1; ++u, i += kTileSlots) {
        // group g of the item's tile u - u0 goes to warp ((u - u0) kGroups + g) % kCons
        const int g = (cw - (u - it.u0) * kGroups % kCons + kCons) % kCons;
        if (g >= kGroups) continue;  // the producer arrived for us
        const unsigned char* box[kTileSlots];
#pragma unroll
        for (int j = 0; j < kTileSlots; ++j) {
          hopper::mbar_wait(full(i + j), parity(i + j));
          box[j] = sm + ((i + j) % kStages) * kStageBytes;
        }
        const int kw0 = u * kTilePos + 16 * g;
        if (kw0 < it.L)
          w16.keys(box[0], box[kBoxes - 1], box[kBoxes], box[kTileSlots - 1],
                   reinterpret_cast<const float*>(box[0] + kTileBytes),
                   reinterpret_cast<const float*>(box[kBoxes] + kTileBytes), 16 * g, kw0,
                   kw0 + 15 > it.L - 1, lim, p.scale_log2, lane);
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kTileSlots; ++j) hopper::mbar_arrive(empty(i + j));
        }
      }
      w16.finish();
      // the warps' partials, merged in warp order into the item's partial
      // (m, l, acc) rows
      cons_sync();  // every warp is past the q rows and the new k/v
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = gid + 8 * e;
        if (r < it.rows) {
          if (tig == 0) {
            s_m[cw * kRows + r] = w16.m_i[e];
            s_l[cw * kRows + r] = w16.l_i[e];
          }
          float* arow = s_acc + (cw * kRows + r) * S::kAccLd + 2 * tig;
#pragma unroll
          for (int t = 0; t < D / 8; ++t)
            *reinterpret_cast<float2*>(arow + t * 8) = make_float2(w16.acc[t][2 * e], w16.acc[t][2 * e + 1]);
        }
      }
      cons_sync();
      float* dst = p.scratch + lay.attn + static_cast<long>(n) * kRows * D;
      float* dml = p.scratch + lay.ml + static_cast<long>(n) * kRows * 2;
      T* ao = reinterpret_cast<T*>(p.scratch + lay.ao) + static_cast<long>(it.b) * p.H + h0 * D;
      for (int e = ct; e < it.rows * D; e += kCons * 32) {
        const int r = e / D;
        const int j = e - r * D;
        float mx = kNeg;
#pragma unroll
        for (int w = 0; w < kCons; ++w) mx = fmaxf(mx, s_m[w * kRows + r]);
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int w = 0; w < kCons; ++w) {
          const float f = hopper::ex2(s_m[w * kRows + r] - mx);
          den += s_l[w * kRows + r] * f;
          num += s_acc[(w * kRows + r) * S::kAccLd + j] * f;
        }
        const int d = W16::col(j);
        if (p.NP == 1) {
          // the whole pair: fold the new token in and normalize
          const float m_all = fmaxf(mx, isn[r]);
          const float f = hopper::ex2(mx - m_all);
          const float f_new = hopper::ex2(isn[r] - m_all);
          ao[r * D + d] = decode_attn::from_float<T>((num * f + f_new * ivn[d]) / (den * f + f_new));
          continue;
        }
        dst[r * D + d] = num;
        if (j == 0) {
          dml[r * 2] = mx;
          dml[r * 2 + 1] = den;
        }
      }
      cons_sync();  // the merge area is read before the next item's q rows
    }
  }

  // LN1's row statistics (one warp a slot) into stats[0..32)
  __device__ void ln1_stats() const {
    float* st = stats();
    for (int b = warp; b < p.B; b += kCons) {
      const T* xr = p.x + static_cast<long>(b) * p.H;
      float s = 0.f;
#pragma unroll 4
      for (int i = 8 * lane; i < p.H; i += 8 * 32) {
        float v[8];
        load8(xr + i, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
      const float mu = warp_sum(s) / p.H;
      float q = 0.f;
#pragma unroll 4
      for (int i = 8 * lane; i < p.H; i += 8 * 32) {
        float v[8];
        load8(xr + i, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) q = fmaf(v[e] - mu, v[e] - mu, q);
      }
      const float var = warp_sum(q) / p.H;
      if (lane == 0) {
        st[b] = mu;
        st[kRows + b] = rsqrtf(var + p.eps);
      }
    }
  }

  // LN2's row statistics from the strips' (mean, M2), merged in strip
  // order (Chan et al.), into stats[32..64); the strips' pairs are loaded
  // all at once into the activation buffer first
  __device__ void ln2_stats() const {
    float* st = stats();
    float2* pairs = reinterpret_cast<float2*>(sm + S::kRing);  // [B][H / 64]
    const int ns = p.H / kStrip;
    for (int e = threadIdx.x; e < p.B * ns; e += kCons * 32) {
      const int b = e / ns;
      const int s = e - b * ns;
      pairs[e] = __ldcg(reinterpret_cast<const float2*>(p.scratch + lay.st2) + s * p.B + b);
    }
    cons_sync();
    const int b = threadIdx.x;
    if (b < p.B) {
      float n = 0.f, mean = 0.f, m2 = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float2 q = pairs[b * ns + s];
        const float nn = n + kStrip;
        const float delta = q.x - mean;
        mean += delta * (kStrip / nn);
        m2 += q.y + delta * delta * (n * kStrip / nn);
        n = nn;
      }
      st[2 * kRows + b] = mean;
      st[3 * kRows + b] = rsqrtf(m2 / p.H + p.eps);
    }
  }

  __device__ void consume() const {
    uint32_t i = 0;
    MEGA_STAMP(0);
    {
      const int n = 2 * (p.H / kStrip) + p.F / kStrip;
      for (int e = blockIdx.x * kCons * 32 + threadIdx.x; e < n; e += gridDim.x * kCons * 32)
        p.work[kStripCounters + e] = 0u;
    }
    ln1_stats();
    if (!(MEGA_SKIP & 1)) consume_product(p.pq, 0, p.scratch + lay.qkv, 0, i);
    MEGA_STAMP(1);
    grid_sync(p.work);
    MEGA_STAMP(2);
    if (!(MEGA_SKIP & 2)) consume_attention(i);
    MEGA_STAMP(3);
    grid_sync(p.work);
    MEGA_STAMP(4);
    if (!(MEGA_SKIP & 4)) consume_product(p.po, 2, p.scratch + lay.out, 1, i);
    MEGA_STAMP(5);
    grid_sync(p.work);
    MEGA_STAMP(6);
    ln2_stats();
    if (!(MEGA_SKIP & 8)) consume_product(p.pu, 3, p.scratch + lay.up, 3, i);
    MEGA_STAMP(7);
    grid_sync(p.work);
    MEGA_STAMP(8);
    if (!(MEGA_SKIP & 16)) consume_product(p.pd, 4, p.scratch + lay.down, 2, i);
    MEGA_STAMP(9);
  }
};

template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1) mega_kernel(const __grid_constant__ Params<T, KV> p) {
  using S = Smem<T, D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(base + S::kBars + 8 * s, 32);             // the producer's lanes
      hopper::mbar_init(base + S::kBars + 8 * (kStages + s), kCons);  // every consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const Kernel<T, KV, D, kPaged> k(p, sm, base);
  if (threadIdx.x >= kCons * 32)
    k.produce();
  else
    k.consume();
}

// What the C entry points pass: pointers in LAYER_WEIGHTS order after x,
// then the cache, tables, lengths, outputs, scratch and workspace; sizes.
struct Args {
  const void* ptr[24];
  int B, H, Hkv, D, F, cap, bs, MB;
  int grid, np;          // blocks (one per SM); position parts of an attention pair
  int parts[4];          // partials a chunk of each product (the wrapper's partition)
  long scratch;          // floats of scratch the wrapper allocated
  int dtype;             // of x, the weights and the outputs: 0 = bf16, 1 = fp16
  float eps;
  void* stream;
};

// tensor maps by what defines them: built once per weight or cache
// pointer and shape, not on every layer step
struct MapKey {
  const void* ptr;
  long a, b, c, d;
  int kind;
};
inline bool map_cached(CUtensorMap* out, const MapKey& key, bool (*make)(CUtensorMap*, const MapKey&)) {
  struct Entry {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  constexpr int kSlots = 4096;
  static Entry table[kSlots];
  static int filled = 0;
  const uintptr_t h0 = (reinterpret_cast<uintptr_t>(key.ptr) >> 6) ^ (key.a * 131) ^ (key.b * 8191) ^
                       (key.c * 524287) ^ (key.d * 31) ^ key.kind;
  for (int probe = 0; probe < kSlots; ++probe) {
    Entry& e = table[(h0 + probe) % kSlots];
    if (!e.used) {
      if (filled >= kSlots / 2) {  // keep the table sparse: start afresh
        for (auto& x : table) x.used = false;
        filled = 0;
        return map_cached(out, key, make);
      }
      if (!make(&e.map, key)) return false;
      e.key = key;
      e.used = true;
      ++filled;
      *out = e.map;
      return true;
    }
    const MapKey& k = e.key;
    if (k.ptr == key.ptr && k.a == key.a && k.b == key.b && k.c == key.c && k.d == key.d &&
        k.kind == key.kind) {
      *out = e.map;
      return true;
    }
  }
  return false;
}

// kind: 0 bf16 weight, 1 fp16 weight (a = rows, b = cols); 2 / 3 bf16 /
// fp16 cache, 4 int8 cache, 5 int8 cache swizzled (a = blocks, b =
// positions, c = Hkv, d = D | rows << 16)
inline bool make_map(CUtensorMap* m, const MapKey& k) {
  if (k.kind < 2) return hopper::map_2d(m, k.ptr, k.kind == 1, static_cast<int>(k.a), static_cast<int>(k.b));
  const int D = static_cast<int>(k.d & 0xffff);
  const int rows = static_cast<int>(k.d >> 16);
  if (k.kind < 4)
    return hopper::map_bshd(m, k.ptr, k.kind == 3, static_cast<int>(k.a), static_cast<int>(k.b),
                            static_cast<int>(k.c), D, rows);
  return hopper::map_bshd_u8(m, k.ptr, static_cast<int>(k.a), static_cast<int>(k.b),
                             static_cast<int>(k.c), D, rows, k.kind == 5);
}

// co-resident blocks of one instantiation per SM, once
template <typename Fn>
int blocks_per_sm(Fn kernel, int smem) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

template <typename T, typename KV, int D, bool kPaged>
int launch(const Args& a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const bool fp16 = std::is_same<T, __half>::value;
  Params<T, KV> p;
  const int Nq = a.H + 2 * a.Hkv * D;
  p.pq = Part(a.H, Nq, a.grid);
  p.po = Part(a.H, a.H, a.grid);
  p.pu = Part(a.H, a.F, a.grid);
  p.pd = Part(a.F, a.H, a.grid);
  Part* parts[4] = {&p.pq, &p.po, &p.pu, &p.pd};
  for (int i = 0; i < 4; ++i) {
    // 32-bit tile arithmetic; the wrapper sized the scratch for its
    // partition: the same one; a strip's partials fit a table row
    if (static_cast<long>(parts[i]->total + 1) * a.grid >= (1L << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    parts[i]->P = a.parts[i];
    if (parts[i]->max_parts() != a.parts[i] ||
        parts[i]->nk / parts[i]->cl * parts[i]->P > kMaxStripParts)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.B = a.B;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.G = a.H / (a.Hkv * D);
  p.F = a.F;
  p.cap = a.cap;
  p.bs = a.bs;
  p.MB = a.MB;
  p.RT = (p.G + kRows - 1) / kRows;
  p.NP = a.np;
  p.eps = a.eps;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const Layout lay(p.B, p.H, p.Hkv, D, p.F, p.RT, p.NP, p.pq, p.po, p.pu, p.pd);
  if (lay.total > a.scratch || kStripCounters + 2 * (a.H / kStrip) + a.F / kStrip > kWorkInts)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const* q = a.ptr;
  const int wk = fp16 ? 1 : 0;
  bool ok = map_cached(&p.tm_qkv, {q[3], a.H, Nq, 0, 0, wk}, make_map) &&
            map_cached(&p.tm_out, {q[5], a.H, a.H, 0, 0, wk}, make_map) &&
            map_cached(&p.tm_up, {q[9], a.H, a.F, 0, 0, wk}, make_map) &&
            map_cached(&p.tm_down, {q[11], a.F, a.H, 0, 0, wk}, make_map);
  // a pool's block count is not passed: its map spans every block id a
  // table can hold
  constexpr int kTilePos = Kernel<T, KV, D, kPaged>::kTilePos;
  p.seg = kPaged ? (window_attn::pool_seg(a.bs) < kTilePos ? window_attn::pool_seg(a.bs) : kTilePos) : kTilePos;
  const long nb = kPaged ? (1L << 30) : a.B;
  const long npos = kPaged ? a.bs : a.cap;
  const int ck = kQuant ? (D == 128 ? 5 : 4) : (fp16 ? 3 : 2);
  ok = ok && map_cached(&p.tm_k, {q[13], nb, npos, a.Hkv, D | (p.seg << 16), ck}, make_map) &&
       map_cached(&p.tm_v, {q[14], nb, npos, a.Hkv, D | (p.seg << 16), ck}, make_map);
  if (!ok) return static_cast<int>(cudaErrorNotSupported);
  p.x = static_cast<const T*>(q[0]);
  p.ln1_w = static_cast<const T*>(q[1]);
  p.ln1_b = static_cast<const T*>(q[2]);
  p.b_qkv = static_cast<const T*>(q[4]);
  p.b_out = static_cast<const T*>(q[6]);
  p.ln2_w = static_cast<const T*>(q[7]);
  p.ln2_b = static_cast<const T*>(q[8]);
  p.b_up = static_cast<const T*>(q[10]);
  p.b_down = static_cast<const T*>(q[12]);
  p.ks = static_cast<const float*>(q[15]);
  p.vs = static_cast<const float*>(q[16]);
  p.tables = static_cast<const int*>(q[17]);
  p.lengths = static_cast<const int*>(q[18]);
  p.x_out = static_cast<T*>(const_cast<void*>(q[19]));
  p.k_new = static_cast<T*>(const_cast<void*>(q[20]));
  p.v_new = static_cast<T*>(const_cast<void*>(q[21]));
  p.scratch = static_cast<float*>(const_cast<void*>(q[22]));
  p.work = static_cast<unsigned*>(const_cast<void*>(q[23]));
  const int smem = Smem<T, D>::kLaunch + (kPaged ? a.MB * 4 : 0);
  auto kernel = mega_kernel<T, KV, D, kPaged>;
  // every block must be resident at once (the grid barriers): one an SM
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.grid < 1 || blocks_per_sm(kernel, smem) * sms < a.grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(a.stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' dispatch.  Returns a cudaError_t.
template <bool kQuant, bool kPaged>
int run(const Args& a) {
  if (a.B < 1 || a.B > kRows || a.Hkv < 1 || a.H % 128 != 0 || a.F % 128 != 0 ||
      a.H % (a.Hkv * a.D) != 0 || (a.D != 64 && a.D != 128) || a.np < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kPaged ? (a.bs < 16 || a.bs % 16 != 0 || a.MB < 1) : a.cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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

// The entry points: ptrs (24), dims (B, H, Hkv, D, F, cap, bs, MB, grid,
// np, four partial counts, scratch floats as two ints (low 31 bits, the
// rest), dtype).
template <bool kQuant, bool kPaged>
int entry(const void* const* ptrs, const int* dims, float eps, void* stream) {
  Args a;
  for (int i = 0; i < 24; ++i) a.ptr[i] = ptrs[i];
  a.B = dims[0];
  a.H = dims[1];
  a.Hkv = dims[2];
  a.D = dims[3];
  a.F = dims[4];
  a.cap = dims[5];
  a.bs = dims[6];
  a.MB = dims[7];
  a.grid = dims[8];
  a.np = dims[9];
  for (int i = 0; i < 4; ++i) a.parts[i] = dims[10 + i];
  a.scratch = static_cast<long>(dims[14]) | (static_cast<long>(dims[15]) << 31);
  a.dtype = dims[16];
  a.eps = eps;
  a.stream = stream;
  return run<kQuant, kPaged>(a);
}

}  // namespace mega
