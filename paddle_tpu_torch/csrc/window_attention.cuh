// Shared device code of the window-attention kernels (window_attention.cu,
// window_attention_q.cu, paged_window_attention.cu,
// paged_window_attention_q.cu): kernel templates over the cache layout
// (dense slot rows [B, S, Hkv, D], or pool blocks [NB, bs, Hkv, D] reached
// through a block table [B, MB]) and the value type (bf16/fp16, or int8
// or e4m3 codes with one f32 scale per (position, kv head); the e4m3
// forms are window_attention_f8.cu and paged_window_attention_f8.cu, read
// through kv_codes.cuh where int8 takes a byte permute).
//
// Contract of every variant (the JAX package's decode_attention_window and
// paged_decode_attention_window): q [B, W, H, D] holds W consecutive new
// tokens per slot whose k/v the cache already holds at positions
// lengths[b] .. lengths[b] + W - 1; lengths[b] counts the tokens cached
// BEFORE the window.  Query i of slot b attends cache positions
// j <= min(lengths[b] + i, cap - 1), cap = S (dense) or MB * bs (paged), so
// no row is ever empty.  GQA native (query head h = hk * G + g).  Paged
// position t of slot b lives at pool[tables[b, t / bs], t % bs]; table
// entries at or past ceil(min(lengths[b] + W, cap) / bs) are not read (the
// null block 0 stands in for them).  o [B, W, H, D] like q.
//
// Two regimes.  The spec-decode verify has W * G = K + 1 query rows (5 at
// K = 4) against a long cache: memory bound, like decode.  A prefill chunk
// has W * G = 512 or more rows: arithmetic bound, like the flash forward.
// - W * G <= 16 (the verify): vq::verify_kernel below.  The bound is
//   the bytes, so they must stay in flight while they are converted and
//   multiplied: one producer warp keeps a three-deep ring of 128-key
//   tiles full (TMA into an mbarrier full / empty ring: 16-bit K/V rows
//   through the 128-byte swizzle, two boxes a D = 128 row; int8 codes and,
//   by cp.async on the same barriers, their f32 scales), up to 192 KB
//   (16-bit) or 99 KB (int8) a block in flight; eight consumer warps take
//   16 keys of every tile each, with mma.sync m16n8k16 and f32
//   accumulation: 16-bit B fragments by ldmatrix (.trans for V) on the
//   swizzled lines, int8 codes dequantized out of shared memory straight
//   into the fragments (byte-permute conversion, code x scale in f32
//   rounded once to q's dtype, as the TPU kernel rounds its dequantized
//   blocks, with the head dimension permuted so every read is a 16-byte
//   vector).  Pool tiles arrive as one box per pool segment, their blocks
//   planned a tile ahead from the slot's table staged in shared memory.
//   One block per (slot, kv head) when B * Hkv fills the SMs; otherwise
//   each pair's key tiles split over a cluster of up to 8 CTAs, merged
//   through distributed shared memory in rank order.
// - W * G > 16 (chunks): chunk_launch below, on the shared wgmma mainloop
//   of hopper_attn_fwd.cuh (128-row tiles, two consumer warpgroups,
//   128-key K/V tiles through a TMA / mbarrier ring).  Tile row r of kv
//   head hk is query (w = r / G, g = r % G), read once per block by the
//   consumers (16-byte loads written in the swizzled layout).  The
//   producer: TMA of the dense cache rows; for pools, one TMA box per
//   block segment of a key tile (64 or 128 rows when bs allows, else 16),
//   block ids from the slot's table staged in shared memory; for int8,
//   one producer warp keeps a three-deep ring of raw items full (the K or
//   the V codes of a tile by TMA, their f32 scales copied by lanes 1-31)
//   and the other three warps of the producer warpgroup dequantize each
//   item (code x scale in f32, rounded once to T) into the swizzled
//   16-bit K/V stage the consumers read, so the consumers never touch
//   int8.
// All read key tiles only up to the block's highest limit
// lengths[b] + w_last + 1 and apply the staircase mask only on tiles
// that cross their lowest row's limit.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper_attn_fwd.cuh"
#include "kv_codes.cuh"
#include "mma_tile.cuh"

namespace window_attn {

using flash::kNeg;
using flash::Mma;
using kv_codes::Code;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// What the C entry points pass: untyped pointers and sizes.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* tables;
  const void* lengths;
  void* o;
  int B, W, S, H, Hkv, D;
  int bs, mb;          // paged only
  int dtype;           // 0 = bf16, 1 = fp16
  void* stream;
};

// ---- the chunk regime (W * G > 16) on the shared wgmma mainloop ----------

// rows of a pool box: a key tile of 128 keys is 128 / seg boxes, each
// inside one block (bs % seg == 0)
inline int pool_seg(int bs) { return bs % 128 == 0 ? 128 : bs % 64 == 0 ? 64 : 16; }

template <typename T, typename KV, int D, bool kPaged>
struct ChunkPolicy {
  static constexpr bool kQuant = Code<KV>::kQuant;
  struct Params {
    CUtensorMap tm_k, tm_v;  // 16-bit swizzled, or int8 codes unswizzled
    const T* q;
    T* o;
    const float* ks;     // int8 only: [B, S, Hkv] dense, [NB, bs, Hkv] paged
    const float* vs;
    const int* tables;   // paged only: [B, mb]
    const int* lengths;  // [B], tokens cached before the window
    int B, W, cap, H, Hkv, G, R, bs, mb, seg;
    float scale;
  };
  static constexpr int kN = attn_fwd::kBlockN;
  static constexpr int kStages = 2;
  // the producer warpgroup dequantizes (int8) or walks block tables
  // (paged), so it keeps more than the flash forward's
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = 224;
  // arrivals completing a stage: the loading warp's lanes, or the 96
  // dequantizing threads
  static constexpr int kFullCount = kQuant ? 96 : 32;
  // int8 raw ring: items (the K or the V codes of a tile, then their 128
  // f32 scales), three deep, each on a 1024-byte boundary
  static constexpr int kRaw = 3;
  static constexpr int kItem = (kN * D + kN * 4 + 1023) / 1024 * 1024;
  static constexpr int kExtra = kQuant ? kRaw * kItem : 0;
  static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
                "register file");

  const Params& p;
  int b, hk, r0, rows_n, len, n_tiles, n_blk;

  __device__ ChunkPolicy(const Params& prm, int blk) : p(prm) {
    // the row tiles of one (slot, kv head) are neighbours in launch
    // order, so its K/V is read from device memory about once and then
    // from L2 (128 heads' K/V at 8 x 2048 would not fit it together);
    // the last (longest) row tile of each goes first.  Chunk row tiles
    // differ little in length, unlike causal flash tiles.
    const int n_rt = (p.R + attn_fwd::kBlockM - 1) / attn_fwd::kBlockM;
    const int bh = blk / n_rt;
    r0 = (n_rt - 1 - blk % n_rt) * attn_fwd::kBlockM;
    b = bh / p.Hkv;
    hk = bh % p.Hkv;
    len = max(p.lengths[b], 0);
    rows_n = min(attn_fwd::kBlockM, p.R - r0);
    const int hi = min(len + (r0 + rows_n - 1) / p.G + 1, p.cap);
    n_tiles = (hi + kN - 1) / kN;
    n_blk = kPaged ? (min(len + p.W, p.cap) + p.bs - 1) / p.bs : 0;
  }

  template <class Ring>
  __device__ void init_bars(const Ring& ring) const {
    if constexpr (kQuant) {
      for (int r = 0; r < kRaw; ++r) {
        hopper::mbar_init(ring.bar(r), 32);        // raw item landed
        hopper::mbar_init(ring.bar(kRaw + r), 96);  // raw item converted
      }
    }
  }

  // cache row of position t: (row * Hkv + hk) is its value row and scale
  __device__ long kv_row(const int* tbl, int t) const {
    if constexpr (kPaged) {
      const int bi = t / p.bs;
      return static_cast<long>(bi < n_blk ? tbl[bi] : 0) * p.bs + (t - bi * p.bs);
    } else {
      return static_cast<long>(b) * p.cap + t;
    }
  }

  // one tensor's key tile at k0 into `dst` (16-bit: D / 64 swizzled boxes
  // of 128 lines; int8: 128 lines of D bytes), issued by one thread
  __device__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           const int* tbl, int k0) const {
    constexpr int kBox = kQuant ? 1 : D / 64;
    constexpr int kLine = kQuant ? D : 128;
    if constexpr (kPaged) {
      for (int i = 0; i < kN / p.seg; ++i) {
        const int t = k0 + i * p.seg;
        const int bi = t / p.bs;
        const int blk = bi < n_blk ? tbl[bi] : 0;  // the null block past them
#pragma unroll
        for (int c = 0; c < kBox; ++c)
          hopper::tma_load_4d(dst + c * kN * 128 + i * p.seg * kLine, map, bar,
                              c * 64, hk, t - bi * p.bs, blk);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kBox; ++c)
        hopper::tma_load_4d(dst + c * kN * 128, map, bar, c * 64, hk, k0, b);
    }
  }

  template <class Ring>
  __device__ void produce(const Ring& ring) const {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    int* tbl = reinterpret_cast<int*>(ring.tail());
    if (tid < 32 && kPaged) {
      for (int i = lane; i < n_blk; i += 32)
        tbl[i] = p.tables[static_cast<long>(b) * p.mb + i];
      __syncwarp();
    }
    if constexpr (!kQuant) {
      if (tid >= 32) return;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(ring.empty(s), ((kt / kStages) - 1) & 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(ring.full(s), 2 * kN * D * 2);
          tma_tile(ring.k(s), &p.tm_k, ring.full(s), tbl, kt * kN);
          tma_tile(ring.v(s), &p.tm_v, ring.full(s), tbl, kt * kN);
        } else {  // lane 0's arrival came with its expect_tx
          hopper::mbar_arrive(ring.full(s));
        }
      }
    } else {
      // warp 0 keeps the raw ring filled, running up to kRaw items ahead
      // (lane 0: TMA of the codes; lanes 1-31: the scales, loaded all at
      // once); warps 1-3 dequantize each item into its 16-bit stage
      const int n_items = 2 * n_tiles;
      if (tid < 32) {
        // scales of item i: lanes 1-31, four or five positions each, one
        // table walk per pool segment (lane 1 + g: segment g; seg is a
        // power of two), each position's row by shuffle
        constexpr int kPer = (kN + 30) / 31;
        auto gather = [&](int i, float* val) {
          const float* scl = i % 2 ? p.vs : p.ks;
          const int k0 = (i / 2) * kN;
          const int lg = __ffs(p.seg) - 1;
          const long seg_row = lane - 1 < (kN >> lg)
                                   ? kv_row(tbl, k0 + ((lane - 1) << lg))
                                   : 0;
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int j = lane - 1 + 31 * u;
            const long row =
                __shfl_sync(0xfffffffeu, seg_row, 1 + (min(j, kN - 1) >> lg)) +
                (j & (p.seg - 1));
            val[u] = j < kN && k0 + j < p.cap ? scl[row * p.Hkv + hk] : 0.f;
          }
        };
        // the next item's loads are issued before this item's slot is
        // waited for, so their latency hides behind the wait
        float cur[kPer], nxt[kPer];
        if (lane != 0) gather(0, cur);
        for (int i = 0; i < n_items; ++i) {
          const int r = i % kRaw;
          const uint32_t dst = ring.extra() + r * kItem;
          if (lane != 0 && i + 1 < n_items) gather(i + 1, nxt);
          if (i >= kRaw)
            hopper::mbar_wait(ring.bar(kRaw + r), ((i / kRaw) - 1) & 1);
          if (lane == 0) {
            hopper::mbar_expect_tx(ring.bar(r), kN * D);
            tma_tile(dst, i % 2 ? &p.tm_v : &p.tm_k, ring.bar(r), tbl,
                     (i / 2) * kN);
          } else {
            float* sc = reinterpret_cast<float*>(ring.at(dst) + kN * D);
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              if (lane - 1 + 31 * u < kN) sc[lane - 1 + 31 * u] = cur[u];
              cur[u] = nxt[u];
            }
            hopper::mbar_arrive(ring.bar(r));
          }
        }
        return;
      }
      const int ct = tid - 32;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(ring.empty(s), ((kt / kStages) - 1) & 1);
#pragma unroll 1
        for (int which = 0; which < 2; ++which) {
          const int i = 2 * kt + which;
          const int r = i % kRaw;
          hopper::mbar_wait(ring.bar(r), (i / kRaw) & 1);
          const unsigned char* codes = ring.at(ring.extra() + r * kItem);
          const float* sc = reinterpret_cast<const float*>(codes + kN * D);
          unsigned char* dst = ring.at(which ? ring.v(s) : ring.k(s));
          // code x scale in f32, rounded once to T, 16 codes a step; the
          // code reaches f32 exactly (kv_codes.cuh: int8 by byte permute
          // without the quarter-rate I2F, e4m3 by cvt, two codes at once)
          using Cd = Code<KV>;
          for (int u = ct; u < kN * (D / 16); u += 96) {
            const int line = u / (D / 16);
            const int c16 = u % (D / 16);
            const uint4 raw = *reinterpret_cast<const uint4*>(codes + line * D + c16 * 16);
            const float f = sc[line];
            const uint32_t w4[4] = {Cd::prep(raw.x), Cd::prep(raw.y), Cd::prep(raw.z),
                                    Cd::prep(raw.w)};
            uint32_t packed[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 c = Cd::pair(w4[j / 2], 2 * (j % 2));
              packed[j] = hopper::pack2<T>(c.x * f, c.y * f);
            }
            *reinterpret_cast<uint4*>(dst + attn_fwd::sw_chunk(kN, line, 2 * c16)) =
                make_uint4(packed[0], packed[1], packed[2], packed[3]);
            *reinterpret_cast<uint4*>(dst + attn_fwd::sw_chunk(kN, line, 2 * c16 + 1)) =
                make_uint4(packed[4], packed[5], packed[6], packed[7]);
          }
          hopper::mbar_arrive(ring.bar(kRaw + r));
        }
        hopper::fence_proxy_async();  // generic writes before wgmma reads
        hopper::mbar_arrive(ring.full(s));
      }
    }
  }

  __device__ const T* q_row(int line) const {
    const int rr = r0 + line;
    if (rr >= p.R) return nullptr;
    return p.q + ((static_cast<long>(b) * p.W + rr / p.G) * p.H +
                  static_cast<long>(hk) * p.G + rr % p.G) * D;
  }

  template <class Ring>
  __device__ void load_q(const Ring& ring, int c, int t) const {
    attn_fwd::load_q_rows<D>(ring, c, t, [&](int line) { return q_row(line); });
  }

  __device__ attn_fwd::WgRows rows(int c) const {
    const int first = r0 + 64 * c;
    attn_fwd::WgRows w;
    w.always = false;
    w.lo = min(len + first / p.G, p.cap - 1);
    w.hi = first >= p.R ? -1
                        : min(len + min(first + 63, p.R - 1) / p.G, p.cap - 1);
    return w;
  }

  template <class Ring>
  __device__ const float* key_mask(const Ring&, int) const { return nullptr; }

  // padded rows take the last row's limit
  __device__ int limit(int row) const {
    return min(len + (r0 + min(row, rows_n - 1)) / p.G, p.cap - 1);
  }

  __device__ T* out(int row) const {
    const T* qr = q_row(row);
    return qr ? p.o + (qr - p.q) : nullptr;
  }

  __device__ void lse(int, float) const {}
};

template <typename T, typename KV, int D, bool kPaged>
int chunk_launch(const Args& a) {
  using P = ChunkPolicy<T, KV, D, kPaged>;
  const bool fp16 = std::is_same<T, __half>::value;
  typename P::Params p;
  const int cap = kPaged ? a.mb * a.bs : a.S;
  // a pool's block count is not passed: its map spans every block id a
  // table can hold (ids are only read, never bounds-checked by TMA here)
  const int nb = kPaged ? (1 << 30) : a.B;
  const int npos = kPaged ? a.bs : a.S;
  p.seg = kPaged ? pool_seg(a.bs) : P::kN;
  bool ok;
  if constexpr (P::kQuant)
    ok = hopper::map_bshd_u8(&p.tm_k, a.k, nb, npos, a.Hkv, D, p.seg) &&
         hopper::map_bshd_u8(&p.tm_v, a.v, nb, npos, a.Hkv, D, p.seg);
  else
    ok = hopper::map_bshd(&p.tm_k, a.k, fp16, nb, npos, a.Hkv, D, p.seg) &&
         hopper::map_bshd(&p.tm_v, a.v, fp16, nb, npos, a.Hkv, D, p.seg);
  if (!ok) return static_cast<int>(cudaErrorNotSupported);
  p.q = static_cast<const T*>(a.q);
  p.o = static_cast<T*>(a.o);
  p.ks = static_cast<const float*>(a.ks);
  p.vs = static_cast<const float*>(a.vs);
  p.tables = static_cast<const int*>(a.tables);
  p.lengths = static_cast<const int*>(a.lengths);
  p.B = a.B;
  p.W = a.W;
  p.cap = cap;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.G = a.H / a.Hkv;
  p.R = a.W * p.G;
  p.bs = a.bs;
  p.mb = a.mb;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  const int n_rt = (p.R + attn_fwd::kBlockM - 1) / attn_fwd::kBlockM;
  return attn_fwd::launch<T, D, P>(p, n_rt * a.B * a.Hkv,
                                   kPaged ? a.mb * 4 : 0,
                                   static_cast<cudaStream_t>(a.stream));
}

// ---- the verify regime (W * G <= 16): an asynchronous K/V ring --------
//
// One block per (kv head, slot, key split): warp 0 produces, warps 1..kCons
// consume.  Each ring stage holds one kTileN-key tile of K and V by TMA:
// 16-bit rows through the 128-byte swizzle (a D = 128 row is two 64-column
// boxes, each kTileN lines of 128 bytes), or int8 codes (one box of D-byte
// lines, swizzled at D = 128) and then the tile's f32 K and V scales
// (4-byte cp.async copies by the producer's lanes 1-31, one block-table
// walk per pool segment, each position's row by shuffle).  Everything of a
// stage completes on its full barrier (TMA bytes and cp.async arrivals),
// so nothing passes through the producer's registers and the producer
// waits only for a free stage.  Every consumer warp takes its own 16 keys
// of each tile (Warp16 below) and keeps its own (m, l, acc) over the
// block's 16 query rows, so all kCons warps work at once while the next
// kStages - 1 tiles load.
//
// 16-bit values reach the mma.sync m16n8k16 B fragments by ldmatrix on the
// swizzled lines (.trans for V).  int8 codes are dequantized straight into
// the fragments, with no 16-bit stage:
// - q k^T: the reduction (head) dimension is permuted so that k index
//   (2 tig + i % 2 + 8 (i / 2)) of 16-wide chunk c is column
//   tig * D / 4 + 4 c + i.  A thread then reads D / 4 contiguous code
//   bytes of its key row, and each 32-bit word is one chunk's B fragment
//   (the Q A fragments are read with the same permutation);
// - p v: B column n of 8-wide output tile t is head column n * D / 8 + t,
//   so a thread reads D / 8 contiguous bytes of each of its four key rows
//   (2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of the warp's 16) and byte t
//   of each is tile t's B fragment.
// An int8 code becomes f32 exactly by byte permute (0x4B0000uu = 2^23 +
// uu, uu = code + 128) and one subtraction, in place of the quarter-rate
// I2F; an e4m3 code by cvt.rn.f16x2.e4m3x2 (kv_codes.cuh); then code x
// scale in f32, rounded once to T (the contract).
//
// When B * Hkv leaves SMs idle, the key tiles of a (slot, kv head) split
// over a thread block cluster of nsplit CTAs; each CTA merges its warps'
// partials in shared memory, then every rank merges one slice of the
// outputs over all ranks' partials through distributed shared memory, in
// rank order.  Every merge runs in a
// fixed order, so a call is bitwise repeatable.
namespace vq {

constexpr int kCons = 8;               // consumer warps
constexpr int kTileN = 16 * kCons;     // keys a stage: 16 per consumer warp
constexpr int kStages = 3;             // ring depth
constexpr int kThreads = 32 * (kCons + 1);
constexpr int kMaxSplit = 8;           // CTAs a cluster (portable limit)

// byte offsets from the 1024-aligned base of dynamic shared memory
template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = Code<KV>::kQuant;
  static constexpr int kCodes = kTileN * D * static_cast<int>(sizeof(KV));  // one tensor a stage
  static constexpr int kStage = (2 * kCodes + (kQuant ? 2 * kTileN * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int kRing = kStages * kStage;
  // after the key loop: each consumer warp's m[16], l[16], acc[16][D + 8]
  static constexpr int kAccLd = D + 8;
  static constexpr int kScratch = kCons * 16 * (2 + kAccLd) * 4;
  static constexpr int kLd = D + 8;  // Q rows (16-bit values)
  static constexpr int kQ = kRing > kScratch ? kRing : kScratch;
  static constexpr int kFin = kQ + 16 * kLd * 2;  // the CTA's m, l, acc
  static constexpr int kBars = kFin + 16 * (2 + kAccLd) * 4;
  static constexpr int kTbl = kBars + 2 * kStages * 8;  // the block table
  static constexpr int kLaunch = kTbl + 1024;           // + alignment slack
};

template <typename T>
struct Params {
  CUtensorMap tm_k, tm_v;  // [B, S, Hkv, D] or [NB, bs, Hkv, D]: 16-bit or int8 codes
  const T* q;
  T* o;
  const float* ks;     // int8 only: [B, S, Hkv] dense, [NB, bs, Hkv] paged
  const float* vs;
  const int* tables;   // paged only: [B, mb]
  const int* lengths;  // [B], tokens cached before the window
  int W, cap, H, Hkv, G, R, bs, mb, seg, nsplit;
  float scale_log2;    // 1 / sqrt(D) * log2(e)
};

// 4 bytes global -> shared, asynchronously; zero-filled when !valid (src
// only has to be a legal address then)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once every earlier cp.async of this thread landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// four 8 x 8 16-bit matrices from shared memory, one row address a lane
// (lanes 8 i .. 8 i + 7: matrix i); .trans hands each lane the column
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// code a x scale fa (low half) and code b x scale fb, rounded to T (byte
// ia of the prepared word wa, ib of wb: kv_codes.cuh)
template <typename T, typename KV>
__device__ __forceinline__ uint32_t dq2(uint32_t wa, int ia, float fa,
                                        uint32_t wb, int ib, float fb) {
  return hopper::pack2<T>(Code<KV>::at(wa, ia) * fa, Code<KV>::at(wb, ib) * fb);
}

// codes i, i + 1 of the prepared word w, both x scale f, rounded to T
template <typename T, typename KV>
__device__ __forceinline__ uint32_t dq2_pair(uint32_t w, int i, float f) {
  const float2 c = Code<KV>::pair(w, i);
  return hopper::pack2<T>(c.x * f, c.y * f);
}

// One consumer warp over 16 query rows: its Q fragments and its online
// softmax state (base 2), fed 16 keys at a time from boxes laid out as the
// ring's (16-bit: 128-byte lines of 64 columns, a D = 128 row in two
// boxes; int8: lines of D code bytes; swizzled at 128 bytes a line, so
// every box starts on a 1024-byte boundary).  Column j of acc's
// fragments is head column col(j).  The decode megakernel's attention
// phase runs the same warps.
template <typename T, typename KV, int D>
struct Warp16 {
  static constexpr bool kQuant = Code<KV>::kQuant;
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  float m_i[2];
  float l_i[2];  // this thread's share of the row sums until finish()

  // Q rows from 16 rows of shared memory (row stride ld elements)
  __device__ __forceinline__ void init(const T* sQ, int ld, int lane) {
    const int gid = lane >> 2;
    const int tig = lane & 3;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      if constexpr (kQuant) {
        const T* r0 = sQ + gid * ld + tig * (D / 4) + 4 * c;
        qf[c][0] = flash::ld32(r0);
        qf[c][1] = flash::ld32(r0 + 8 * ld);
        qf[c][2] = flash::ld32(r0 + 2);
        qf[c][3] = flash::ld32(r0 + 8 * ld + 2);
      } else {
        flash::load_a(qf[c], sQ, ld, 0, c * 16, gid, tig);
      }
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    m_i[0] = m_i[1] = kNeg;
    l_i[0] = l_i[1] = 0.f;
  }

  // keys kw0 .. kw0 + 15 on lines l0 .. l0 + 15 (l0 a multiple of 16) of
  // the K and V values (16-bit at D = 128: columns 0-63 in boxes ck, cv,
  // 64-127 in ck1, cv1; int8: scales sk, sv by line); key kw0 + i is
  // visible to fragment row e when !masked or <= lim[e]
  __device__ __forceinline__ void keys(const unsigned char* ck, const unsigned char* ck1,
                                       const unsigned char* cv, const unsigned char* cv1,
                                       const float* sk, const float* sv, int l0, int kw0,
                                       bool masked, const int* lim, float scale_log2, int lane) {
    const int gid = lane >> 2;
    const int tig = lane & 3;
    // S = Q K^T over the 16 keys (n8 tile j: keys + 8 j)
    float sf[2][4];
    sf[0][0] = sf[0][1] = sf[0][2] = sf[0][3] = 0.f;
    sf[1][0] = sf[1][1] = sf[1][2] = sf[1][3] = 0.f;
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int line = l0 + 8 * j + gid;
        const float f = sk[line];
        uint32_t w[D / 16];
        if constexpr (D == 128) {
          // chunks 2 tig, 2 tig + 1 of the line, swizzled by line % 8 = gid
          const uint4 x0 = *reinterpret_cast<const uint4*>(ck + line * 128 + (((2 * tig) ^ gid) << 4));
          const uint4 x1 = *reinterpret_cast<const uint4*>(ck + line * 128 + (((2 * tig + 1) ^ gid) << 4));
          w[0] = x0.x; w[1] = x0.y; w[2] = x0.z; w[3] = x0.w;
          w[4] = x1.x; w[5] = x1.y; w[6] = x1.z; w[7] = x1.w;
        } else {
          const uint4 x0 = *reinterpret_cast<const uint4*>(ck + line * D + tig * 16);
          w[0] = x0.x; w[1] = x0.y; w[2] = x0.z; w[3] = x0.w;
        }
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint32_t x = Code<KV>::prep(w[c]);
          const uint32_t bf[2] = {dq2_pair<T, KV>(x, 0, f), dq2_pair<T, KV>(x, 2, f)};
          Mma<T>::run(sf[j], qf[c], bf);
        }
      }
    } else {
      // x4 matrices: keys 0-7 / 8-15 (lanes 16-31) x columns 16 c .. + 7 /
      // 16 c + 8 .. + 15 (lanes 8-15, 24-31)
      const uint32_t kb[2] = {hopper::smem_u32(ck), hopper::smem_u32(ck1)};
      const int line = l0 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int chunk = 2 * c + ((lane >> 3) & 1);
        uint32_t r[4];
        ldsm_x4(r, kb[c / 4] + line * 128 + (((chunk & 7) ^ (line & 7)) << 4));
        const uint32_t b0[2] = {r[0], r[1]};
        const uint32_t b1[2] = {r[2], r[3]};
        Mma<T>::run(sf[0], qf[c], b0);
        Mma<T>::run(sf[1], qf[c], b1);
      }
    }
    // online softmax in base 2, the mask only where asked
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw0 + 8 * j + 2 * tig + (e & 1);
        const bool ok = !masked || key <= lim[e >> 1];
        const float val = ok ? sf[j][e] * scale_log2 : kNeg;
        sf[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = hopper::ex2(m_i[r] - mx[r]);
      l_i[r] *= alpha[r];
      m_i[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = sf[j][e];
        const float pr = val <= 0.5f * kNeg ? 0.f : hopper::ex2(val - mx[e >> 1]);
        sf[j][e] = pr;
        l_i[e >> 1] += pr;
      }
    }
    // a running max that moved rescales the accumulators (alpha = 1
    // exactly otherwise)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][0] *= alpha[0];
        acc[t][1] *= alpha[0];
        acc[t][2] *= alpha[1];
        acc[t][3] *= alpha[1];
      }
    }
    const uint32_t pa[4] = {Mma<T>::pack(sf[0][0], sf[0][1]),
                            Mma<T>::pack(sf[0][2], sf[0][3]),
                            Mma<T>::pack(sf[1][0], sf[1][1]),
                            Mma<T>::pack(sf[1][2], sf[1][3])};
    if constexpr (kQuant) {
      // O += P V: key rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of the
      // 16, D / 8 code bytes each (head columns gid * D / 8 + t)
      uint32_t v[4][D / 32];
      float fv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int line = l0 + 2 * tig + (e & 1) + 8 * (e >> 1);
        fv[e] = sv[line];
        using Cd = Code<KV>;
        if constexpr (D == 128) {
          const uint4 x = *reinterpret_cast<const uint4*>(cv + line * 128 + ((gid ^ (line & 7)) << 4));
          v[e][0] = Cd::prep(x.x); v[e][1] = Cd::prep(x.y);
          v[e][2] = Cd::prep(x.z); v[e][3] = Cd::prep(x.w);
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(cv + line * D + gid * 8);
          v[e][0] = Cd::prep(x.x); v[e][1] = Cd::prep(x.y);
        }
      }
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const uint32_t bf[2] = {dq2<T, KV>(v[0][t / 4], t % 4, fv[0], v[1][t / 4], t % 4, fv[1]),
                                dq2<T, KV>(v[2][t / 4], t % 4, fv[2], v[3][t / 4], t % 4, fv[3])};
        Mma<T>::run(acc[t], pa, bf);
      }
    } else {
      // O += P V: x4.trans matrices keys 0-7 / 8-15 (lanes 8-15, 24-31) x
      // columns 8 t .. / 8 (t + 1) .. (lanes 16-31)
      const uint32_t vb[2] = {hopper::smem_u32(cv), hopper::smem_u32(cv1)};
      const int line = l0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int t = 0; t < D / 8; t += 2) {
        const int chunk = t + (lane >> 4);
        uint32_t r[4];
        ldsm_x4_t(r, vb[t / 8] + line * 128 + (((chunk & 7) ^ (line & 7)) << 4));
        const uint32_t b0[2] = {r[0], r[1]};
        const uint32_t b1[2] = {r[2], r[3]};
        Mma<T>::run(acc[t], pa, b0);
        Mma<T>::run(acc[t + 1], pa, b1);
      }
    }
  }

  // the row sums over the quad (call once, after the last keys)
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    }
  }

  // head column of fragment column j (8 t + 2 tig + i of acc[t][i])
  static __device__ __forceinline__ int col(int j) {
    return kQuant ? (j % 8) * (D / 8) + j / 8 : j;
  }
};

template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
    verify_kernel(const __grid_constant__ Params<T> p) {
  using L = Layout<KV, D>;
  constexpr bool kQuant = L::kQuant;
  // a 16-bit row is D / 64 boxes of 128-byte lines; an int8 row one box of
  // D bytes
  constexpr int kLine = kQuant ? D : 128;
  constexpr int kBoxes = kQuant ? 1 : D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  T* sQ = reinterpret_cast<T*>(sm + L::kQ);
  int* tbl = reinterpret_cast<int*>(sm + L::kTbl);
  auto full = [&](int s) { return base + L::kBars + 8 * s; };
  auto empty = [&](int s) { return base + L::kBars + 8 * (kStages + s); };

  const int rank = blockIdx.x;  // the CTA's rank in its cluster
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = p.R;
  const int len = max(p.lengths[b], 0);
  const int hi = min(len + (rows - 1) / p.G + 1, p.cap);  // keys [0, hi)
  const int lo_lim = min(len, p.cap - 1);  // every row sees keys <= this
  const int n_tiles = (hi + kTileN - 1) / kTileN;
  const int per = (n_tiles + p.nsplit - 1) / p.nsplit;
  const int t0 = min(n_tiles, rank * per);
  const int n = min(n_tiles, t0 + per) - t0;  // this CTA's tiles
  const int n_blk = kPaged ? (min(len + p.W, p.cap) + p.bs - 1) / p.bs : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 32);     // lane 0's TMA + 31 lanes (int8: their cp.async)
      hopper::mbar_init(empty(s), kCons);  // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  // the block's query rows r = w * G + g -> q[b, w, hk * G + g]; padded
  // rows zero; the slot's live table entries
  for (int i = threadIdx.x; i < 16 * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const long off = ((static_cast<long>(b) * p.W + r / p.G) * p.H +
                        static_cast<long>(hk) * p.G + r % p.G) * D + c;
      val = *reinterpret_cast<const uint4*>(p.q + off);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::kLd + c) = val;
  }
  if constexpr (kPaged) {
    for (int i = threadIdx.x; i < n_blk; i += kThreads)
      tbl[i] = p.tables[static_cast<long>(b) * p.mb + i];
  }
  __syncthreads();

  // a consumer warp's state: its (m, l, acc) over the 16 rows
  const int cw = warp - 1;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  Warp16<T, KV, D> st16;

  if (warp == 0) {
    // ---- producer: lane 0 issues the codes' TMA, lanes 1-31 copy the
    // scales by cp.async; both complete on the stage's full barrier, so
    // the warp blocks only on a free stage.  Each tile's pool blocks and
    // scale rows (one block-table walk per pool segment, by lanes 1-8 at
    // most; each position's row by shuffle) are worked out while the
    // previous tile's stage is still busy; the scale of position j goes to
    // j (K) and kTileN + j (V) of the stage's scale area, zero past the
    // capacity.  16-bit tiles have no scales: lanes 1-31 only arrive.
    constexpr int kPer = (2 * kTileN + 30) / 31;
    constexpr int kSegs = kPaged ? kTileN / 16 : 1;
    const int nseg = kPaged ? kTileN / p.seg : 1;
    const int lg = kPaged ? __ffs(p.seg) - 1 : 0;
    int sblk[kSegs], soff[kSegs];
    long srow[kPer];
    auto plan = [&](int kt) {
      const int k0 = kt * kTileN;
      long seg_row = 0;
      if constexpr (kPaged) {
        // lane 1 + g walks the table for segment g; every lane takes the
        // blocks and offsets by shuffle (lane 0 issues their boxes)
        int blk = 0, off = 0;
        const int t = k0 + ((lane - 1) << lg);
        const int bi = t / p.bs;
        if (lane >= 1 && lane - 1 < nseg) {
          blk = bi < n_blk ? tbl[bi] : 0;
          off = t - bi * p.bs;
        }
#pragma unroll
        for (int g = 0; g < kSegs; ++g) {
          sblk[g] = __shfl_sync(0xffffffffu, blk, 1 + g);
          soff[g] = __shfl_sync(0xffffffffu, off, 1 + g);
        }
        seg_row = static_cast<long>(blk) * p.bs + off;
      }
      if constexpr (kQuant) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int pos = (lane - 1 + 31 * u) & (kTileN - 1);
          if constexpr (kPaged)
            srow[u] = __shfl_sync(0xffffffffu, seg_row, 1 + (pos >> lg)) + (pos & (p.seg - 1));
          else
            srow[u] = static_cast<long>(b) * p.cap + k0 + pos;
        }
      }
    };
    if (n > 0) plan(t0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int k0 = (t0 + i) * kTileN;
      if (i >= kStages) hopper::mbar_wait(empty(s), ((i / kStages) - 1) & 1);
      const uint32_t st = base + s * L::kStage;
      if (lane == 0) {
        hopper::mbar_expect_tx(full(s), 2 * L::kCodes);
        if constexpr (kQuant && kPaged) {
#pragma unroll
          for (int g = 0; g < kSegs; ++g) {
            if (g < nseg) {
              hopper::tma_load_4d(st + g * p.seg * D, &p.tm_k, full(s), 0, hk, soff[g], sblk[g]);
              hopper::tma_load_4d(st + L::kCodes + g * p.seg * D, &p.tm_v, full(s), 0, hk, soff[g], sblk[g]);
            }
          }
        } else if constexpr (kQuant) {
          hopper::tma_load_4d(st, &p.tm_k, full(s), 0, hk, k0, b);
          hopper::tma_load_4d(st + L::kCodes, &p.tm_v, full(s), 0, hk, k0, b);
        } else {
#pragma unroll
          for (int c = 0; c < kBoxes; ++c) {
            const uint32_t box = st + c * kTileN * kLine;
            if constexpr (kPaged) {
#pragma unroll
              for (int g = 0; g < kSegs; ++g) {
                if (g < nseg) {
                  hopper::tma_load_4d(box + g * p.seg * kLine, &p.tm_k, full(s), c * 64, hk, soff[g], sblk[g]);
                  hopper::tma_load_4d(box + L::kCodes + g * p.seg * kLine, &p.tm_v, full(s), c * 64, hk,
                                      soff[g], sblk[g]);
                }
              }
            } else {
              hopper::tma_load_4d(box, &p.tm_k, full(s), c * 64, hk, k0, b);
              hopper::tma_load_4d(box + L::kCodes, &p.tm_v, full(s), c * 64, hk, k0, b);
            }
          }
        }
      } else if constexpr (kQuant) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int j = lane - 1 + 31 * u;
          const bool live = k0 + (j & (kTileN - 1)) < p.cap;
          const float* scl = j < kTileN ? p.ks : p.vs;
          if (j < 2 * kTileN)
            cp_async4(st + 2 * L::kCodes + 4 * j, live ? scl + srow[u] * p.Hkv + hk : scl, live);
        }
        cp_async_arrive(full(s));
      } else {
        hopper::mbar_arrive(full(s));
      }
      if (i + 1 < n) plan(t0 + i + 1);
    }
  } else {
    // ---- consumers
    st16.init(sQ, L::kLd, lane);
    int lim[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      lim[e] = min(len + min(gid + 8 * e, rows - 1) / p.G, p.cap - 1);

    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int kw0 = (t0 + i) * kTileN + 16 * cw;  // the warp's first key
      hopper::mbar_wait(full(s), (i / kStages) & 1);
      if (kw0 < hi) {
        // the staircase mask only where the warp's keys cross some row's
        // limit
        const unsigned char* ck = sm + s * L::kStage;
        const unsigned char* cv = ck + L::kCodes;
        const float* sc = reinterpret_cast<const float*>(ck + 2 * L::kCodes);
        st16.keys(ck, ck + kTileN * 128, cv, cv + kTileN * 128, sc, sc + kTileN, 16 * cw, kw0,
                  kw0 + 15 > lo_lim, lim, p.scale_log2, lane);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }
    st16.finish();
  }
  __syncthreads();  // every warp is done with the ring: it becomes scratch
  // what each consumer warp leaves for the merge
  float* s_m = reinterpret_cast<float*>(sm);
  float* s_l = s_m + kCons * 16;
  float* s_acc = s_l + kCons * 16;  // [kCons][16][kAccLd], fragment columns
  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = gid + 8 * e;
      if (tig == 0) {
        s_m[cw * 16 + r] = st16.m_i[e];
        s_l[cw * 16 + r] = st16.l_i[e];
      }
      float* arow = s_acc + (cw * 16 + r) * L::kAccLd + 2 * tig;
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        *reinterpret_cast<float2*>(arow + t * 8) = make_float2(st16.acc[t][2 * e], st16.acc[t][2 * e + 1]);
    }
  }
  __syncthreads();

  // merge the warps' partials in warp order; fragment column j of a
  // partial row is head column Warp16::col(j)
  float* f_m = reinterpret_cast<float*>(sm + L::kFin);
  float* f_l = f_m + 16;
  float* f_acc = f_l + 16;  // [16][kAccLd]
  auto out = [&](int r, int j, float val) {
    const int d = Warp16<T, KV, D>::col(j);
    p.o[((static_cast<long>(b) * p.W + r / p.G) * p.H +
         static_cast<long>(hk) * p.G + r % p.G) * D + d] = from_float<T>(val);
  };
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int j = i % D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kCons; ++w) mx = fmaxf(mx, s_m[w * 16 + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kCons; ++w) {
      const float f = hopper::ex2(s_m[w * 16 + r] - mx);
      den += s_l[w * 16 + r] * f;
      num += s_acc[(w * 16 + r) * L::kAccLd + j] * f;
    }
    if (p.nsplit == 1) {
      out(r, j, num / fmaxf(den, 1e-30f));
    } else {
      f_acc[r * L::kAccLd + j] = num;
      if (j == 0) {
        f_m[r] = mx;
        f_l[r] = den;
      }
    }
  }
  if (p.nsplit == 1) return;
  // the ranks' partials, merged in rank order; each rank writes its own
  // slice of the outputs, every rank's loads for one output issued at once
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int slice = (rows * D + p.nsplit - 1) / p.nsplit;
  const int end = min(rows * D, (rank + 1) * slice);
  for (int i = rank * slice + threadIdx.x; i < end; i += kThreads) {
    const int r = i / D;
    const int j = i % D;
    float mk[kMaxSplit], lk[kMaxSplit], ak[kMaxSplit];
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) {
      mk[k] = kNeg;
      lk[k] = ak[k] = 0.f;
      if (k < p.nsplit) {
        mk[k] = cluster.map_shared_rank(f_m, k)[r];
        lk[k] = cluster.map_shared_rank(f_l, k)[r];
        ak[k] = cluster.map_shared_rank(f_acc, k)[r * L::kAccLd + j];
      }
    }
    float mx = kNeg;
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) mx = fmaxf(mx, mk[k]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) {
      const float f = hopper::ex2(mk[k] - mx);
      den += lk[k] * f;
      num += ak[k] * f;
    }
    out(r, j, num / fmaxf(den, 1e-30f));
  }
  cluster.sync();  // every rank's shared memory has been read
}

// SMs of the current device
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

// the key split: enough CTAs that B * Hkv pairs fill the SMs once, at most
// kMaxSplit, at most one per key tile of the capacity
inline int split_for(int pairs, int cap) {
  int ns = sm_count() / pairs;
  ns = ns < 1 ? 1 : ns > kMaxSplit ? kMaxSplit : ns;
  const int tiles = (cap + kTileN - 1) / kTileN;
  return ns < tiles ? ns : tiles;
}

template <typename T, typename KV, int D, bool kPaged>
int launch(const Args& a) {
  constexpr bool kQuant = Code<KV>::kQuant;
  Params<T> p;
  const int cap = kPaged ? a.mb * a.bs : a.S;
  // a pool's block count is not passed: its map spans every block id a
  // table can hold, as the chunk regime's
  const int nb = kPaged ? (1 << 30) : a.B;
  const int npos = kPaged ? a.bs : a.S;
  p.seg = kPaged && pool_seg(a.bs) < kTileN ? pool_seg(a.bs) : kTileN;
  const bool ok = kQuant ? hopper::map_bshd_u8(&p.tm_k, a.k, nb, npos, a.Hkv, D, p.seg, D == 128) &&
                               hopper::map_bshd_u8(&p.tm_v, a.v, nb, npos, a.Hkv, D, p.seg, D == 128)
                         : hopper::map_bshd(&p.tm_k, a.k, a.dtype == 1, nb, npos, a.Hkv, D, p.seg) &&
                               hopper::map_bshd(&p.tm_v, a.v, a.dtype == 1, nb, npos, a.Hkv, D, p.seg);
  if (!ok) return static_cast<int>(cudaErrorNotSupported);
  p.q = static_cast<const T*>(a.q);
  p.o = static_cast<T*>(a.o);
  p.ks = static_cast<const float*>(a.ks);
  p.vs = static_cast<const float*>(a.vs);
  p.tables = static_cast<const int*>(a.tables);
  p.lengths = static_cast<const int*>(a.lengths);
  p.W = a.W;
  p.cap = cap;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.G = a.H / a.Hkv;
  p.R = a.W * p.G;
  p.bs = a.bs;
  p.mb = a.mb;
  p.nsplit = split_for(a.B * a.Hkv, cap);
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const int smem = Layout<KV, D>::kLaunch + (kPaged ? a.mb * 4 : 0);
  auto kernel = verify_kernel<T, KV, D, kPaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsplit, a.Hkv, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(a.stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.nsplit > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vq

// the verify (the whole group of one kv head in 16 rows) on the ring of
// mma.sync consumers (vq); chunks on the shared wgmma mainloop
template <typename T, typename KV, int D, bool kPaged>
int by_rows(const Args& a) {
  if (a.W * (a.H / a.Hkv) <= 16) return vq::launch<T, KV, D, kPaged>(a);
  return chunk_launch<T, KV, D, kPaged>(a);
}

// The entry points' dispatch: value type (KV = T when C is void, else
// the codes C: int8_t or __nv_fp8_e4m3), dtype of q and o, D in {64,
// 128}.  Returns a cudaError_t.
template <typename C, bool kPaged>
int run(const Args& a) {
  if (a.B <= 0 || a.W <= 0 || a.Hkv <= 0 || a.H <= 0 || a.H % a.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kPaged) {
    if (a.bs <= 0 || a.bs % 16 != 0 || a.mb <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (a.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  using BF = __nv_bfloat16;
  using FH = __half;
  constexpr bool kQuant = !std::is_void<C>::value;
  using KB = typename std::conditional<kQuant, C, BF>::type;
  using KH = typename std::conditional<kQuant, C, FH>::type;
  if (a.dtype == 0 && a.D == 128) return by_rows<BF, KB, 128, kPaged>(a);
  if (a.dtype == 0 && a.D == 64) return by_rows<BF, KB, 64, kPaged>(a);
  if (a.dtype == 1 && a.D == 128) return by_rows<FH, KH, 128, kPaged>(a);
  if (a.dtype == 1 && a.D == 64) return by_rows<FH, KH, 64, kPaged>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace window_attn
