// Shared device code of the window-attention kernels (window_attention.cu,
// window_attention_q.cu, paged_window_attention.cu,
// paged_window_attention_q.cu): one kernel template over the cache layout
// (dense slot rows [B, S, Hkv, D], or pool blocks [NB, bs, Hkv, D] reached
// through a block table [B, MB]) and the value type (bf16/fp16, or int8
// codes with one f32 scale per (position, kv head)).
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
// Two regimes, two kernels.  The spec-decode verify has W * G = K + 1
// query rows (5 at K = 4) against a long cache: memory bound, like
// decode.  A prefill chunk has W * G = 512 or more rows: arithmetic
// bound, like the flash forward.
// - W * G <= 16 (the verify): window_kernel below, on mma.sync m16n8k16
//   (mma_tile.cuh) with f32 accumulation and online softmax over 64-key
//   tiles.  The four warps of a block hold the same 16 rows (w, g) of one
//   kv head and split the key tiles between them (warp w takes tiles w,
//   w + 4, ...), each streaming its own K/V buffer by cp.async, so the
//   block keeps four tiles of loads in flight and no K/V is streamed for
//   padded rows.  int8 tiles are loaded to registers, dequantized to q's
//   dtype (code x scale in f32, rounded, as the TPU kernel rounds its
//   dequantized blocks) and staged in shared memory.  The partial (m, l,
//   acc) of the key splits merge through shared memory in a fixed order,
//   so results do not depend on scheduling.
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
// Both read key tiles only up to the block's highest limit
// lengths[b] + w_last + 1 and apply the staircase mask only on tiles
// that cross their lowest row's limit.
#pragma once

#include <type_traits>

#include "hopper_attn_fwd.cuh"
#include "mma_tile.cuh"

namespace window_attn {

using flash::kNeg;
using flash::Mma;

constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16;  // rows a block: the whole verify group

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

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (no
// bytes are read then, src only has to be a legal address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// barrier over the `n` threads (whole warps) that share K/V buffer `id`
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <typename T, typename KV>
struct Params {
  const T* q;
  const KV* k;
  const KV* v;
  const float* ks;     // int8 only: [B, S, Hkv] dense, [NB, bs, Hkv] paged
  const float* vs;
  const int* tables;   // paged only: [B, mb]
  const int* lengths;  // [B], tokens cached before the window
  T* o;
  int W, cap;          // cap: positions a slot can hold (S, or mb * bs)
  int H, Hkv, G, R;    // R = W * G rows per kv head
  int bs, mb;          // paged only
  float scale;
};

template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const Params<T, KV> p) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kSplit = kWarps / (kBQ / 16);       // warps per row slice
  constexpr int kGroup = kThreads / kSplit;        // threads per K/V buffer
  constexpr int kLd = D + 8;
  constexpr int kDChunks = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kKTiles = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);                    // [kBQ][kLd]
  T* sKV = sQ + kBQ * kLd;                   // kSplit x (K, V) [kBlockK][kLd]
  int* s_tbl = reinterpret_cast<int*>(sKV + kSplit * 2 * kBlockK * kLd);
  // after the key loop the K/V area holds the merge of the key splits
  float* s_m = reinterpret_cast<float*>(sKV);                // [kSplit][kBQ]
  float* s_l = s_m + kSplit * kBQ;                            // [kSplit][kBQ]
  float* s_acc = s_l + kSplit * kBQ;                          // [kSplit][kBQ][D]

  const int r0 = blockIdx.x * kBQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int split = warp % kSplit;                 // this warp's key split
  const int wrow = (warp / kSplit) * 16;           // its first row
  const int gtid = (warp / kSplit) * 32 + lane;    // index in its buffer group

  const int len = max(p.lengths[b], 0);
  const int rows = min(kBQ, p.R - r0);
  const int w_first = r0 / p.G;
  const int w_last = (r0 + rows - 1) / p.G;
  const int hi = min(len + w_last + 1, p.cap);     // keys [0, hi) are read
  const int lo_lim = min(len + w_first, p.cap - 1);  // every row sees <= this
  const int n_tiles = (hi + kBlockK - 1) / kBlockK;
  const int n_blk = kPaged ? (min(len + p.W, p.cap) + p.bs - 1) / p.bs : 0;

  if constexpr (kPaged) {
    for (int i = threadIdx.x; i < n_blk; i += kThreads)
      s_tbl[i] = p.tables[static_cast<long>(b) * p.mb + i];
  }
  // the block's query rows (w, g) -> q[b, w, hk * G + g]; padded rows zero
  for (int i = threadIdx.x; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int rr = r0 + r;
      const long off = ((static_cast<long>(b) * p.W + rr / p.G) * p.H +
                        static_cast<long>(hk) * p.G + rr % p.G) * D + c;
      val = *reinterpret_cast<const uint4*>(p.q + off);
    }
    *reinterpret_cast<uint4*>(sQ + r * kLd + c) = val;
  }
  __syncthreads();

  uint32_t qf[kDChunks][4];
#pragma unroll
  for (int c = 0; c < kDChunks; ++c)
    flash::load_a(qf[c], sQ, kLd, wrow, c * 16, gid, tig);
  float acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_i[2] = {kNeg, kNeg};
  float l_i[2] = {0.f, 0.f};
  // each fragment row's last visible key (padded rows take the last row's)
  int lim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = r0 + min(wrow + gid + 8 * e, rows - 1);
    lim[e] = min(len + rr / p.G, p.cap - 1);
  }

  // cache row of position t (values at (row * Hkv + hk) * D, scale at
  // row * Hkv + hk), or -1 past the capacity
  auto kv_row = [&](int t) -> long {
    if (t >= p.cap) return -1;
    if constexpr (kPaged) {
      const int bi = t / p.bs;
      const int blk = bi < n_blk ? s_tbl[bi] : 0;
      return static_cast<long>(blk) * p.bs + (t - bi * p.bs);
    } else {
      return static_cast<long>(b) * p.cap + t;
    }
  };

  T* sK = sKV + split * 2 * kBlockK * kLd;
  T* sV = sK + kBlockK * kLd;

  for (int kt = split; kt < n_tiles; kt += kSplit) {
    const int k0 = kt * kBlockK;
    group_sync(1 + split, kGroup);                 // the buffer is free
    if constexpr (!kQuant) {
      constexpr int kVecPerRow = D / 8;
      for (int i = gtid; i < kBlockK * kVecPerRow; i += kGroup) {
        const int r = i / kVecPerRow;
        const int c = (i % kVecPerRow) * 8;
        const long row = kv_row(k0 + r);
        const long off = row >= 0 ? (row * p.Hkv + hk) * D + c : 0;
        cp_async16(sK + r * kLd + c, p.k + off, row >= 0);
        cp_async16(sV + r * kLd + c, p.v + off, row >= 0);
      }
      cp_async_wait_all();
    } else {
      // 16 codes per 16-byte vector; all of a thread's vectors of one
      // tensor are loaded before any is converted
      constexpr int kVecPerRow = D / 16;
      constexpr int kPer = kBlockK * kVecPerRow / kGroup;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const KV* src = which == 0 ? p.k : p.v;
        const float* scl = which == 0 ? p.ks : p.vs;
        T* dst = which == 0 ? sK : sV;
        uint4 raw[kPer];
        float sc[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = gtid + u * kGroup;
          const long row = kv_row(k0 + i / kVecPerRow);
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          sc[u] = 0.f;
          if (row >= 0) {
            const long r = row * p.Hkv + hk;
            raw[u] = __ldg(reinterpret_cast<const uint4*>(
                src + r * D + (i % kVecPerRow) * 16));
            sc[u] = __ldg(scl + r);
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = gtid + u * kGroup;
          const uint32_t w4[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
          uint32_t packed[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t word = w4[j / 2];
            const int sh = 16 * (j % 2);
            const float lo = static_cast<float>(
                static_cast<int8_t>((word >> sh) & 0xffu)) * sc[u];
            const float hi_v = static_cast<float>(
                static_cast<int8_t>((word >> (sh + 8)) & 0xffu)) * sc[u];
            packed[j] = Mma<T>::pack(lo, hi_v);
          }
          T* d = dst + (i / kVecPerRow) * kLd + (i % kVecPerRow) * 16;
          *reinterpret_cast<uint4*>(d) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
          *reinterpret_cast<uint4*>(d + 8) =
              make_uint4(packed[4], packed[5], packed[6], packed[7]);
        }
      }
    }
    group_sync(1 + split, kGroup);                 // the tile has landed

    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) {
        uint32_t bf[2];
        flash::load_b_rows(bf, sK, kLd, nt * 8, c * 16, gid, tig);
        Mma<T>::run(s[nt], qf[c], bf);
      }
    }
    // staircase mask only where the tile crosses some row's limit
    const bool masked = k0 + kBlockK - 1 > lo_lim;
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tig * 2 + (e & 1);
        const bool ok = !masked || key <= lim[e >> 1];
        const float val = ok ? s[nt][e] * p.scale : kNeg;
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
        const float pr = val <= 0.5f * kNeg ? 0.f : __expf(val - mx[e >> 1]);
        s[nt][e] = pr;
        rowsum[e >> 1] += pr;
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
#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) {
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[2 * c][0], s[2 * c][1]);
      pa[1] = Mma<T>::pack(s[2 * c][2], s[2 * c][3]);
      pa[2] = Mma<T>::pack(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int t = 0; t < kDTiles; ++t) {
        uint32_t bf[2];
        flash::load_b_cols(bf, sV, kLd, c * 16, t * 8, gid, tig);
        Mma<T>::run(acc[t], pa, bf);
      }
    }
  }

  // merge the key splits in a fixed order
  __syncthreads();                                 // every K/V buffer is done
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = wrow + gid + 8 * e;
    if (tig == 0) {
      s_m[split * kBQ + r] = m_i[e];
      s_l[split * kBQ + r] = l_i[e];
    }
    float* arow = s_acc + (static_cast<long>(split) * kBQ + r) * D + tig * 2;
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      arow[t * 8] = acc[t][2 * e];
      arow[t * 8 + 1] = acc[t][2 * e + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    float mx = kNeg;
#pragma unroll
    for (int sp = 0; sp < kSplit; ++sp) mx = fmaxf(mx, s_m[sp * kBQ + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int sp = 0; sp < kSplit; ++sp) {
      const float f = __expf(s_m[sp * kBQ + r] - mx);
      den += s_l[sp * kBQ + r] * f;
      num += s_acc[(sp * kBQ + r) * D + c] * f;
    }
    const int rr = r0 + r;
    const long off = ((static_cast<long>(b) * p.W + rr / p.G) * p.H +
                      static_cast<long>(hk) * p.G + rr % p.G) * D + c;
    p.o[off] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
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

template <typename T, typename KV, int D, bool kPaged>
int launch(const Args& a) {
  constexpr int kSplit = kWarps / (kBQ / 16);
  const size_t smem =
      (static_cast<size_t>(kBQ) + kSplit * 2 * kBlockK) * (D + 8) * sizeof(T) +
      (kPaged ? static_cast<size_t>(a.mb) * sizeof(int) : 0);
  auto kernel = window_kernel<T, KV, D, kPaged>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params<T, KV> p;
  p.q = static_cast<const T*>(a.q);
  p.k = static_cast<const KV*>(a.k);
  p.v = static_cast<const KV*>(a.v);
  p.ks = static_cast<const float*>(a.ks);
  p.vs = static_cast<const float*>(a.vs);
  p.tables = static_cast<const int*>(a.tables);
  p.lengths = static_cast<const int*>(a.lengths);
  p.o = static_cast<T*>(a.o);
  p.W = a.W;
  p.cap = kPaged ? a.mb * a.bs : a.S;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.G = a.H / a.Hkv;
  p.R = a.W * p.G;
  p.bs = a.bs;
  p.mb = a.mb;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  dim3 grid((p.R + kBQ - 1) / kBQ, a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the chunk regime (W * G > 16) on the shared wgmma mainloop ----------

// rows of a pool box: a key tile of 128 keys is 128 / seg boxes, each
// inside one block (bs % seg == 0)
inline int pool_seg(int bs) { return bs % 128 == 0 ? 128 : bs % 64 == 0 ? 64 : 16; }

template <typename T, typename KV, int D, bool kPaged>
struct ChunkPolicy {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
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
          // code reaches f32 exactly without the quarter-rate I2F:
          // 0x4B0000uu is 2^23 + uu, uu = code + 128
          for (int u = ct; u < kN * (D / 16); u += 96) {
            const int line = u / (D / 16);
            const int c16 = u % (D / 16);
            const uint4 raw = *reinterpret_cast<const uint4*>(codes + line * D + c16 * 16);
            const float f = sc[line];
            const uint32_t w4[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                    raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
            uint32_t packed[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t sel = 0x7540u + 2 * (j % 2);
              const float lo =
                  __uint_as_float(__byte_perm(w4[j / 2], 0x4B000000u, sel)) - 8388736.f;
              const float hi =
                  __uint_as_float(__byte_perm(w4[j / 2], 0x4B000000u, sel + 1)) - 8388736.f;
              packed[j] = hopper::pack2<T>(lo * f, hi * f);
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

// the verify (the whole group of one kv head in 16 rows) on mma.sync,
// chunks on the shared wgmma mainloop
template <typename T, typename KV, int D, bool kPaged>
int by_rows(const Args& a) {
  if (a.W * (a.H / a.Hkv) <= 16) return launch<T, KV, D, kPaged>(a);
  return chunk_launch<T, KV, D, kPaged>(a);
}

// The entry points' dispatch: value type (KV = T, or int8 codes when
// kQuant), dtype of q and o, D in {64, 128}.  Returns a cudaError_t.
template <bool kQuant, bool kPaged>
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
  using KB = typename std::conditional<kQuant, int8_t, BF>::type;
  using KH = typename std::conditional<kQuant, int8_t, FH>::type;
  if (a.dtype == 0 && a.D == 128) return by_rows<BF, KB, 128, kPaged>(a);
  if (a.dtype == 0 && a.D == 64) return by_rows<BF, KB, 64, kPaged>(a);
  if (a.dtype == 1 && a.D == 128) return by_rows<FH, KH, 128, kPaged>(a);
  if (a.dtype == 1 && a.D == 64) return by_rows<FH, KH, 64, kPaged>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace window_attn
