// One warp-specialised forward-attention mainloop for Hopper (sm_90a),
// shared by the flash forward (flash_fwd.cu) and the prefill-chunk regime
// of the window kernels (window_attention.cuh): causal-style online-softmax
// attention of a tall block of query rows over a long run of keys.
//
// A block is 128 query rows: a producer warpgroup and two consumer
// warpgroups of 64 rows each (setmaxnreg moves registers from the producer
// to the consumers).  Key tiles of 128 keys stream through a ring of
// kStages shared-memory stages (K then V, each as D / 64 boxes of 128-byte
// swizzled lines, hopper_tile.cuh), guarded by a full and an empty
// mbarrier per stage.  Per key tile, each consumer warpgroup:
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, K-major;
// - online softmax in base 2: x = s * scale * log2(e) in one multiply,
//   2^(x - m) on the special-function unit, the running max m and sum l
//   per row reduced over the four threads of a row; masking only on the
//   tiles the policy marks (a row's limit, the key edge, a key mask);
// - O += P V: P packed from the f32 scores as the register A operand
//   (pack_a) and consumed within the tile, V read MN-major through the
//   transpose bit.
// The epilogue scales O by 1 / l (fully masked rows give exact zeros),
// stages it in the warpgroup's own Q rows and writes 16-byte vectors.
//
// A policy P supplies what differs between the kernels:
//   Params (the __grid_constant__ kernel argument, tensor maps included),
//   kStages, kProducerRegs, kConsumerRegs, kFullCount (arrivals that
//   complete a stage), kExtra (bytes of the policy's own shared memory),
//   P(params, blockIdx.x): the block's rows and key range; n_tiles;
//   init_bars(ring): its own mbarriers (ring.bar(i), i < 8);
//   produce(ring): the producer warpgroup's whole work;
//   load_q(ring, c, t): consumer warpgroup c's 64 Q rows in place;
//   rows(c): the warpgroup's key range and mask thresholds;
//   key_mask(ring, s): stage s's 128 key-mask values, or null;
//   limit(row): a tile row's last visible key;
//   out(row): where a tile row's output goes (null: not written);
//   lse(row, value): the row's natural-log lse (a no-op where unused).
// A policy with kDropout = true (the flash forward's dropout form) also
// gives b, h and q0, and Params philox (the (seed, offset) pair),
// drop_thr and drop_scale (1 / (1 - p)): each consumer thread draws its
// tile's keep bits (philox.cuh) before it waits for the tile, zeroes the
// dropped p after they entered the row sums l (the softmax normaliser
// runs over every key) and before the P V product, and scales o by
// drop_scale once, in the epilogue.  Policies without kDropout compile
// to the mainloop without it.
#pragma once

#include <type_traits>

#include "hopper_tile.cuh"
#include "philox.cuh"

namespace attn_fwd {

using hopper::Wgmma;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockM = 128;  // query rows a block: two consumers x 64
constexpr int kBlockN = 128;  // keys a tile
constexpr int kThreads = 384;  // producer warpgroup + two consumers

// byte offsets from the 1024-aligned base of dynamic shared memory
template <int D, int kStages, int kExtra>
struct Smem {
  static constexpr int kTileQ = kBlockM * D * 2;
  static constexpr int kTileKV = kBlockN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kRing = kTileQ;  // stage s: K, then V
  static constexpr int kStage = 2 * kTileKV;
  static constexpr int kMask = kRing + kStages * kStage;  // 128 f32 a stage
  static constexpr int kExtraAt = kMask + kStages * kBlockN * 4;
  static constexpr int kBars = (kExtraAt + kExtra + 7) / 8 * 8;
  static constexpr int kNumBars = 1 + 2 * kStages + 8;  // q, full, empty, policy
  static constexpr int kBytes = kBars + kNumBars * 8;
  static constexpr int kLaunch = kBytes + 1024;  // + alignment slack
  static constexpr int kTail = kBytes;  // the policy's dynamic bytes
};

// shared-memory addresses of one block's ring
template <int D, int kStages, int kExtra>
struct Ring {
  using L = Smem<D, kStages, kExtra>;
  uint32_t base;
  unsigned char* gbase;
  __device__ uint32_t q() const { return base + L::kQ; }
  __device__ uint32_t bar_q() const { return base + L::kBars; }
  __device__ uint32_t full(int s) const { return base + L::kBars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return base + L::kBars + 8 * (1 + kStages + s);
  }
  // policy barrier i (i < 8)
  __device__ uint32_t bar(int i) const {
    return base + L::kBars + 8 * (1 + 2 * kStages + i);
  }
  __device__ uint32_t k(int s) const { return base + L::kRing + s * L::kStage; }
  __device__ uint32_t v(int s) const { return k(s) + L::kTileKV; }
  __device__ float* mask(int s) const {
    return reinterpret_cast<float*>(gbase + L::kMask + s * kBlockN * 4);
  }
  __device__ uint32_t extra() const { return base + L::kExtraAt; }
  __device__ unsigned char* tail() const { return gbase + L::kTail; }
  // generic pointer to a shared address of this block
  __device__ unsigned char* at(uint32_t addr) const {
    return gbase + (addr - base);
  }
};

// byte offset of the 16-byte chunk `ch` (8 values) of line `line` in a
// swizzled tile of `lines` lines (box ch / 8, chunk ch % 8 of the line)
__device__ __forceinline__ uint32_t sw_chunk(int lines, int line, int ch) {
  return (ch >> 3) * lines * 128 + line * 128 + (((ch & 7) ^ (line & 7)) << 4);
}

// P::kDropout where the policy has it, else false
template <class P, class = void>
struct HasDropout : std::false_type {};
template <class P>
struct HasDropout<P, std::void_t<decltype(P::kDropout)>>
    : std::integral_constant<bool, P::kDropout> {};

// a thread's dropout state: empty without dropout
template <bool kOn>
struct DropState {
  template <class Prm, class Pol>
  __device__ DropState(const Prm&, const Pol&) {}
};
template <>
struct DropState<true> : philox::Dropout {
  template <class Prm, class Pol>
  __device__ DropState(const Prm& prm, const Pol& pol)
      : philox::Dropout(prm.philox, pol.b * prm.H + pol.h, prm.drop_thr) {}
};

// a consumer warpgroup's key range: tiles starting past `hi` are skipped;
// tiles ending past `lo` (or every tile when `always`) are masked
struct WgRows {
  int hi, lo;
  bool always;
};

template <typename T, int D, class P>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const __grid_constant__ typename P::Params prm) {
  constexpr int kStages = P::kStages;
  constexpr bool kDrop = HasDropout<P>::value;
  using R = Ring<D, kStages, P::kExtra>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  R ring;
  ring.base = (raw + 1023u) & ~1023u;
  ring.gbase = smem_raw + (ring.base - raw);
  const P pol(prm, blockIdx.x);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hopper::mbar_init(ring.bar_q(), 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(ring.full(s), P::kFullCount);
      hopper::mbar_init(ring.empty(s), 8);  // one arrival per consumer warp
    }
    pol.init_bars(ring);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<P::kProducerRegs>();
    pol.produce(ring);
    return;
  }
  hopper::setmaxnreg_inc<P::kConsumerRegs>();
  const int c = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  pol.load_q(ring, c, t);

  // this thread's rows: accumulator elements 0, 1 (row r0) and 2, 3 (r0 + 8)
  const int r0 = c * 64 + warp * 16 + gid;
  const int lim[2] = {pol.limit(r0), pol.limit(r0 + 8)};
  const WgRows wr = pol.rows(c);
  const float sl2 = prm.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const uint32_t a_q = ring.q() + c * 64 * 128;
  const DropState<kDrop> drop(prm, pol);

  for (int kt = 0; kt < pol.n_tiles; ++kt) {
    const int s = kt % kStages;
    const int k0 = kt * kBlockN;
    // the tile's keep bits, drawn while its loads are in flight: bit i is
    // accumulator element i (one call per two 8-key groups)
    uint32_t keep[2] = {0u, 0u};
    if constexpr (kDrop) {
      if (k0 <= wr.hi) {
#pragma unroll
        for (int g2 = 0; g2 < kBlockN / 16; ++g2)
          keep[g2 >> 2] |= drop.row_bits(drop.call(
                               pol.q0 + r0, k0 + 16 * g2 + 2 * tig))
                           << (8 * (g2 & 3));
      }
    }
    hopper::mbar_wait(ring.full(s), (kt / kStages) & 1);
    if (k0 <= wr.hi) {
      const uint32_t sk = ring.k(s), sv = ring.v(s);
      float st[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const uint32_t off = (j / 4) * kBlockN * 128 + (j % 4) * 32;
        Wgmma<T, 128, 0>::ss(
            st, hopper::desc_sw128(a_q + (j / 4) * kBlockM * 128 + (j % 4) * 32, 16, 1024),
            hopper::desc_sw128(sk + off, 16, 1024), j > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<64>(st);

      // element i: key k0 + 8 (i / 4) + 2 tig + (i & 1), row (i >> 1) & 1
      float mx[2] = {m[0], m[1]};
      const bool masked = wr.always || k0 + kBlockN - 1 > wr.lo;
      if (masked) {
        const float* km = pol.key_mask(ring, s);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = (i / 4) * 8 + tig * 2 + (i & 1);
          const int row = (i >> 1) & 1;
          const bool ok = k0 + col <= lim[row] && (!km || km[col] > 0.f);
          st[i] = ok ? st[i] * sl2 : kNeg;
          mx[row] = fmaxf(mx[row], st[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          st[i] *= sl2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], st[i]);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if (masked) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int row = (i >> 1) & 1;
          st[i] = st[i] <= 0.5f * kNeg ? 0.f : hopper::ex2(st[i] - mx[row]);
          sum[row] += st[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int row = (i >> 1) & 1;
          st[i] = hopper::ex2(st[i] - mx[row]);
          sum[row] += st[i];
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        alpha[r] = hopper::ex2(m[r] - mx[r]);
        l[r] = l[r] * alpha[r] + sum[r];
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      if constexpr (kDrop) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (!((keep[i >> 5] >> (i & 31)) & 1u)) st[i] = 0.f;
      }

      uint32_t pa[8][4];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) hopper::pack_a<T>(pa[cc], st, cc);
      hopper::wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        Wgmma<T, D, 1>::rs(
            o, pa[cc], hopper::desc_sw128(sv + cc * 16 * 128, kBlockN * 128, 1024),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(o);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(s));
  }

  // epilogue: o / l in T, staged in this warpgroup's own Q rows (no wgmma
  // reads them any more), then 16-byte vectors to device memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float inv = 1.f / fmaxf(l[r], 1e-30f);
    if constexpr (kDrop) inv *= prm.drop_scale;
    const int line = r0 + 8 * r;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ring.at(ring.q()) +
                                   sw_chunk(kBlockM, line, n) + 4 * tig) =
          hopper::pack2<T>(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    if (tig == 0)
      pol.lse(line, m[r] <= 0.5f * kNeg
                        ? kNeg + logf(fmaxf(l[r], 1e-30f))
                        : m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f)));
  }
  hopper::named_sync(1 + c, 128);
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int line = c * 64 + i / (D / 8);
    const int ch = i % (D / 8);
    T* dst = pol.out(line);
    if (dst)
      *reinterpret_cast<uint4*>(dst + ch * 8) = *reinterpret_cast<const uint4*>(
          ring.at(ring.q()) + sw_chunk(kBlockM, line, ch));
  }
}

// consumer warpgroup c loads its 64 Q rows itself: row `line` of the tile
// from `src(line)` (null: zeros), written in the swizzled layout, then
// made visible to wgmma
template <int D, class Ring, class Src>
__device__ __forceinline__ void load_q_rows(const Ring& ring, int c, int t,
                                            Src src) {
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int line = c * 64 + i / (D / 8);
    const int ch = i % (D / 8);
    const auto* row = src(line);
    const uint4 val = row ? *reinterpret_cast<const uint4*>(row + ch * 8)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(ring.at(ring.q()) + sw_chunk(kBlockM, line, ch)) =
        val;
  }
  hopper::fence_proxy_async();
  hopper::named_sync(1 + c, 128);
}

// launch one instantiation with `extra` bytes of shared memory past the
// barriers (a policy's table).  The limit is raised on every call: a
// function-local static would be one object for every library of the
// process that instantiates the same policy (a GNU unique symbol), so
// only the first library loaded would raise its own kernel's limit.
constexpr int kMaxSmem = 232448;

template <typename T, int D, class P>
int launch(const typename P::Params& prm, int blocks, int extra,
           cudaStream_t stream) {
  const int smem = Smem<D, P::kStages, P::kExtra>::kLaunch + extra;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_kernel<T, D, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_fwd_kernel<T, D, P><<<blocks, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_fwd
