// Flash-attention forward for Hopper (sm_90a): o and per-row lse of
// softmax(scale * q k^T + mask) v, bf16 or fp16 inputs, f32 accumulation.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd_gqa).  Same contract: causal or full attention, an optional key
// mask [B, S] (1 = attend), GQA native (query head h = hk * G + g reads
// kv head hk), fully masked rows give exact zeros, lse = m + log(max(l,
// 1e-30)) in the natural log, kept for the backward kernels.
//
// What bounds it: at the prefill and training shapes (S up to 2048,
// D = 128) the work is 4 * S^2 * D FLOPs per head (halved under causal)
// against O(S * D) bytes, far above the H100's ~295 FLOP/byte ridge, so
// the tensor cores bound it.  The design is the shared mainloop of
// hopper_attn_fwd.cuh: 128-row q tiles of one (batch, head), two consumer
// warpgroups on wgmma, the scores kept in registers (online softmax in
// base 2 on the special-function unit), 128-key K/V tiles streamed by TMA
// through a two-stage mbarrier ring from one producer warp.  Here:
// - q, k and v come through [B, S, H, D] tensor maps (map_bshd); keys
//   and rows past S arrive as TMA zeros and are masked or not written, so
//   S may be any length (the prefill buckets, ragged batches);
// - the producer warp's lanes 1-31 copy each tile's 128 key-mask values
//   (0 past S) into its ring stage; lane 0 issues the TMA loads;
// - the causal and key masks run only on the tiles that cross a row's
//   diagonal, the key edge S, or carry a key mask; under causal each
//   consumer stops at its own diagonal and the last q tiles (the longest
//   key loops) of every head are launched first.
// Attention dropout (flash_fwd_dropout; the JAX package drops in its
// composite, nn/functional/attention.py:_sdpa_reference, since the TPU
// kernel takes none): the same kernel with kDropout, keep bits from
// Philox4x32-10 of the (seed, offset) pair in device memory (philox.cuh),
// about 13 integer operations an element (one call per 8 elements, drawn
// while the tile's loads are in flight) against the 512 products of its
// two D = 128 dot products.
#include <type_traits>

#include "hopper_attn_fwd.cuh"

namespace {

using attn_fwd::kBlockM;
using attn_fwd::kBlockN;

template <typename T, int D, bool kDrop>
struct FlashPolicy {
  struct Params {
    CUtensorMap tm_q, tm_k, tm_v;
    const float* kv_mask;  // [B, S] or null
    T* o;
    float* lse;
    int B, S, H, Hkv, causal;
    float scale;
    const int64_t* philox;  // dropout: the (seed, offset) pair
    uint32_t drop_thr;      // keep iff a 16-bit field >= drop_thr
    float drop_scale;       // 1 / (1 - p)
  };
  static constexpr bool kDropout = kDrop;
  static constexpr int kStages = 2;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kFullCount = 32;  // the producer warp's lanes
  static constexpr int kExtra = 0;
  static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
                "register file");

  const Params& p;
  int b, h, hk, q0, n_tiles;

  __device__ FlashPolicy(const Params& prm, int blk) : p(prm) {
    // longest first: under causal every head's last q tile (the longest
    // key loop) is launched before any shorter one (flash_fwd_variants.py
    // times the other order, each head's tiles together)
    const int n_qt = (p.S + kBlockM - 1) / kBlockM;
    const int bh = blk % (p.B * p.H);
    int qt = blk / (p.B * p.H);
    if (p.causal) qt = n_qt - 1 - qt;
    b = bh / p.H;
    h = bh % p.H;
    hk = h / (p.H / p.Hkv);
    q0 = qt * kBlockM;
    n_tiles = (p.S + kBlockN - 1) / kBlockN;
    if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBlockM, p.S) - 1) / kBlockN + 1);
  }

  template <class Ring>
  __device__ void init_bars(const Ring&) const {}

  template <class Ring>
  __device__ void produce(const Ring& ring) const {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hopper::mbar_expect_tx(ring.bar_q(), kBlockM * D * 2);
      hopper::tma_load_rows<D>(ring.q(), &p.tm_q, ring.bar_q(), kBlockM, b, h,
                               q0);
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages)
        hopper::mbar_wait(ring.empty(s), ((kt / kStages) - 1) & 1);
      const int k0 = kt * kBlockN;
      if (lane == 0) {
        hopper::mbar_expect_tx(ring.full(s), 2 * kBlockN * D * 2);
        hopper::tma_load_rows<D>(ring.k(s), &p.tm_k, ring.full(s), kBlockN, b,
                                 hk, k0);
        hopper::tma_load_rows<D>(ring.v(s), &p.tm_v, ring.full(s), kBlockN, b,
                                 hk, k0);
      } else {  // lane 0's arrival came with its expect_tx
        if (p.kv_mask) {
          float* m = ring.mask(s);
          for (int j = lane - 1; j < kBlockN; j += 31) {
            const int key = k0 + j;
            m[j] = key < p.S ? p.kv_mask[static_cast<long>(b) * p.S + key] : 0.f;
          }
        }
        hopper::mbar_arrive(ring.full(s));
      }
    }
  }

  template <class Ring>
  __device__ void load_q(const Ring& ring, int, int) const {
    hopper::mbar_wait(ring.bar_q(), 0);
  }

  __device__ attn_fwd::WgRows rows(int c) const {
    const int first = q0 + 64 * c;
    const int last = min(first + 63, p.S - 1);
    attn_fwd::WgRows r;
    r.hi = first >= p.S ? -1 : p.causal ? last : p.S - 1;
    r.lo = p.causal ? min(first, p.S - 1) : p.S - 1;
    r.always = p.kv_mask != nullptr;
    return r;
  }

  template <class Ring>
  __device__ const float* key_mask(const Ring& ring, int s) const {
    return p.kv_mask ? ring.mask(s) : nullptr;
  }

  __device__ int limit(int row) const {
    return p.causal ? min(q0 + row, p.S - 1) : p.S - 1;
  }

  __device__ T* out(int row) const {
    const int qi = q0 + row;
    if (qi >= p.S) return nullptr;
    return p.o + ((static_cast<long>(b) * p.S + qi) * p.H + h) * D;
  }

  __device__ void lse(int row, float value) const {
    const int qi = q0 + row;
    if (qi < p.S) p.lse[(static_cast<long>(b) * p.H + h) * p.S + qi] = value;
  }
};

template <typename T, int D, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* o, void* lse, int B, int S, int H, int Hkv, int causal,
           const void* philox, int drop_thr, float drop_scale,
           cudaStream_t stream) {
  using P = FlashPolicy<T, D, kDrop>;
  const bool fp16 = std::is_same<T, __half>::value;
  typename P::Params prm;
  // tensor maps hold the data pointers: encoded on every call
  if (!hopper::map_bshd(&prm.tm_q, q, fp16, B, S, H, D, kBlockM) ||
      !hopper::map_bshd(&prm.tm_k, k, fp16, B, S, Hkv, D, kBlockN) ||
      !hopper::map_bshd(&prm.tm_v, v, fp16, B, S, Hkv, D, kBlockN))
    return static_cast<int>(cudaErrorNotSupported);
  prm.kv_mask = static_cast<const float*>(kv_mask);
  prm.o = static_cast<T*>(o);
  prm.lse = static_cast<float*>(lse);
  prm.B = B;
  prm.S = S;
  prm.H = H;
  prm.Hkv = Hkv;
  prm.causal = causal;
  prm.scale = 1.f / sqrtf(static_cast<float>(D));
  prm.philox = static_cast<const int64_t*>(philox);
  prm.drop_thr = static_cast<uint32_t>(drop_thr);
  prm.drop_scale = drop_scale;
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  return attn_fwd::launch<T, D, P>(prm, n_qt * B * H, 0, stream);
}

template <bool kDrop>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask,
             void* o, void* lse, int B, int S, int H, int Hkv, int D,
             int causal, int dtype, const void* philox, int drop_thr,
             float drop_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128, kDrop>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64, kDrop>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 1 && D == 128)
    return launch<__half, 128, kDrop>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  if (dtype == 1 && D == 64)
    return launch<__half, 64, kDrop>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, causal, philox, drop_thr, drop_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, S, H, D], k/v [B, S, Hkv, D], kv_mask [B, S] f32 or null, all
// contiguous and 16-byte aligned; o like q; lse [B, H, S] f32.  dtype:
// 0 = bf16, 1 = fp16.  Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* o, void* lse, int B, int S,
                         int H, int Hkv, int D, int causal, int dtype,
                         void* stream) {
  return dispatch<false>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, D, causal,
                         dtype, nullptr, 0, 1.f, stream);
}

// flash_fwd with attention dropout: philox the (seed, offset) int64 pair
// in device memory, drop_thr = round(p * 65536) (an element is kept iff
// its 16-bit Philox field is at least that), drop_scale = 1 / (1 - p).
// o is the dropped output; lse is the softmax's, as without dropout.
extern "C" int flash_fwd_dropout(const void* q, const void* k, const void* v,
                                 const void* kv_mask, void* o, void* lse,
                                 int B, int S, int H, int Hkv, int D,
                                 int causal, int dtype, const void* philox,
                                 int drop_thr, float drop_scale,
                                 void* stream) {
  if (!philox || drop_thr < 0 || drop_thr > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, kv_mask, o, lse, B, S, H, Hkv, D, causal,
                        dtype, philox, drop_thr, drop_scale, stream);
}
