"""Variants of the Hopper forward-attention mainloop
(``paddle_tpu_torch/csrc/hopper_attn_fwd.cuh``) and of the int8 verify
window's code ring (``window_attention.cuh``, ``vq::verify_q_kernel``),
timed against the committed kernels on one NVIDIA GPU.

    python3 flash_fwd_variants.py [variant ...]

Each variant (all of them, or those named) is the committed sources
with one edit made here (to
``flash_fwd.cu``, ``window_attention.cuh`` or the shared header),
compiled alone with the package's nvcc flags into
``build/fwd_variants/<variant>/``.  Every variant is first run at a few
shapes against the plain version (the per-row check of
``chip_smoke.py``; the variants that drop work are expected to fail
it), then all are timed in turns, forward and backward order
alternating, three rounds, best round reported, each round one replay
of a CUDA graph of 50 calls (200 for the verify shapes): the flash
forward at
B=4, S=2048, H=16, D=128, causal, the chunk window (B=8, W=512,
8 x 1536 cached, H=16, D=128) dense bf16, dense int8 and paged int8
(blocks of 128) and paged bf16 (``pchunk:``), and the verify window
(W=5, 2043 cached a slot, H=16, D=128) dense and paged (blocks of 128),
bf16 (``verify:``, ``pverify:``) and int8 at B=8 (``verify_q:``,
``pverify_q:``) and B=1 (``verify_q1:``, ``pverify_q1:``).  What they
show:

- ``fwd:tile_fastest``: the flash forward launched with each head's q
  tiles together (longest first within a head) in place of every head's
  longest tile first; ``chunk:head_fastest`` (``chunk_q:``, ``pchunk_q:``
  for int8): the window kernel the other way round, every (slot, kv
  head)'s longest row tile first, so the blocks in flight span more
  heads' K/V than L2 holds;
- ``fwd:stages3``: the flash forward's K/V ring three deep in place of
  two (232 KB of shared memory: one block an SM either way);
- ``fwd:no_softmax`` / ``fwd:no_scores`` / ``fwd:no_pv``: the flash
  forward without the exponentials, without the score product (q k^T)
  or without the p v product: what each part costs (wrong results,
  timing only);
- ``chunk:no_pv``: the same cut in the window kernel (bf16);
- ``fwd:overlap`` / ``chunk:overlap``: the key loop with the p v product
  of the previous tile in flight while this tile's softmax runs
  (FlashAttention-3's intra-warpgroup overlap);
- ``fwd:overlap2`` / ``chunk:overlap2``: the same overlap with the
  first tile peeled, so no wgmma sits on a divergent path (ptxas
  serializes the wgmmas of ``overlap``: its note C7520);
- ``fwd:overlap3`` / ``chunk:overlap3``: the same with no wgmma inside
  any branch (both warpgroups run every tile of the block, fully masked
  where past their rows) and each tile's barrier wait before p is
  packed;
- ``fwd:pingpong`` / ``chunk:pingpong``: the two consumer warpgroups
  take turns issuing their score products on two named barriers, so
  one's softmax runs beside the other's products (FlashAttention-3's
  ping-pong);
- ``chunk_q:no_convert`` / ``pchunk_q:no_convert``: the dense / paged
  int8 window kernel whose producer warps skip the dequantization (the
  stage keeps whatever it held): what the conversion costs;
  ``pchunk_q:no_scales`` / ``chunk_q:no_scales``: the paged / dense
  int8 kernel without the scale copy (wrong results, timing only); ``pchunk_q:walk_each``: the paged int8 kernel
  walking the block table for every position's scale (one division and
  one table read each) in place of once per pool segment;
  ``pchunk_q:no_prefetch``: the next item's scale loads issued after its
  ring slot is free, not before;
- ``verify_q:no_convert`` / ``pverify_q:no_convert``: the int8 verify
  kernel whose consumers take the raw code words as their fragments (no
  conversion; wrong results, timing only); ``*:no_scales``: no scale
  loads (timing only);
- ``verify_q:stages2`` / ``stages4`` / ``stages6`` (and ``pverify_q:``):
  the code ring two, four or six tiles deep in place of three;
- ``verify_q:warps4`` / ``warps4_stages6``: four consumer warps on 64-key
  tiles in place of eight on 128-key tiles, with the ring three or six
  deep (the latter keeps the committed bytes in flight);
- ``verify_q:split2``: each (slot, kv head) split over a cluster of two
  CTAs at B=8 (two waves); ``verify_q1:no_cluster`` /
  ``pverify_q1:no_cluster``: no cluster split at B=1 (16 blocks);
- ``pverify_q:walk_each``: the paged kernel walking the block table for
  every position's scale (a division and a table read each) in place of
  once per pool segment;
- ``verify_q:scales_in_regs`` / ``pverify_q:scales_in_regs`` (and
  ``pverify_q:walk_each_in_regs``): the scales loaded into the producer
  lanes' registers one tile ahead and stored before the lanes' arrival,
  in place of cp.async copies that complete on the stage's barrier (the
  arrival then waits for the next tile's loads);
- ``verify_q:plan_after_wait`` / ``pverify_q:plan_after_wait``: the
  producer works out a tile's pool blocks and scale rows after its stage
  is free, in place of while the previous stage is busy;
- ``verify_q:prev`` / ``pverify_q:prev`` (and ``*1:prev``): the earlier
  int8 verify design (the codes loaded to registers, converted by I2F and
  staged as 16-bit tiles by four warps), and ``verify:prev``,
  ``pverify:prev``, ``chunk:prev``, ``pchunk:prev``, ``chunk_q:prev``,
  ``pchunk_q:prev``: the window kernels outside the int8 verify regime,
  each built from a copy of the previous sources in
  ``build/baseline_csrc/`` when that directory exists (for example
  ``git archive <commit> paddle_tpu_torch/csrc | tar -x
  --strip-components=2 -C build/baseline_csrc``).

Needs nvcc and one CUDA device; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "fwd_variants"
HEADER = "hopper_attn_fwd.cuh"


def _edit(old, new):
    def fn(text):
        if old not in text:
            raise SystemExit(f"variant edit no longer applies: {old[:60]!r}")
        return text.replace(old, new)
    return fn


def _cut(start, end, keep=""):
    """Remove the text from ``start`` up to and including ``end``."""
    def fn(text):
        a = text.index(start)
        b = text.index(end, a) + len(end)
        return text[:a] + keep + text[b:]
    return fn


_NO_SCORES = _cut(
    "      hopper::wgmma_fence();\n#pragma unroll\n      for (int j = 0; j < D / 16; ++j) {",
    "      hopper::fence_regs<64>(st);",
    "#pragma unroll\n      for (int i = 0; i < 64; ++i) st[i] = 0.01f * i;\n"
    "      hopper::fence_regs<64>(st);")
_NO_PV = _cut(
    "      hopper::wgmma_fence();\n#pragma unroll\n      for (int cc = 0; cc < 8; ++cc)\n"
    "        Wgmma<T, D, 1>::rs(",
    "      hopper::fence_regs<D / 2>(o);",
    '      asm volatile("" ::"r"(pa[0][0]), "r"(pa[7][3]));')

# the key loop with the p v product of tile n - 1 in flight while the
# exponentials of tile n run (FlashAttention-3's intra-warpgroup overlap)
_OVERLAP_LOOP = """  float alpha_prev[2] = {1.f, 1.f};
  uint32_t pa[8][4];
  int s_prev = -1;
  for (int kt = 0; kt < pol.n_tiles; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(ring.full(s), (kt / kStages) & 1);
    const int k0 = kt * kBlockN;
    if (k0 > wr.hi) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(ring.empty(s));
      continue;
    }
    if (s_prev >= 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha_prev[(i >> 1) & 1];
    }
    const uint32_t sk = ring.k(s);
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
    if (s_prev >= 0) {
      const uint32_t sv = ring.v(s_prev);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        Wgmma<T, D, 1>::rs(
            o, pa[cc], hopper::desc_sw128(sv + cc * 16 * 128, kBlockN * 128, 1024),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs<64>(st);

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
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = (i >> 1) & 1;
      st[i] = masked && st[i] <= 0.5f * kNeg ? 0.f : hopper::ex2(st[i] - mx[row]);
      sum[row] += st[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha_prev[r] = hopper::ex2(m[r] - mx[r]);
      l[r] = l[r] * alpha_prev[r] + sum[r];
      m[r] = mx[r];
    }
    if (s_prev >= 0) {
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(ring.empty(s_prev));
    }
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) hopper::pack_a<T>(pa[cc], st, cc);
    s_prev = s;
  }
  if (s_prev >= 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha_prev[(i >> 1) & 1];
    const uint32_t sv = ring.v(s_prev);
    hopper::wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      Wgmma<T, D, 1>::rs(
          o, pa[cc], hopper::desc_sw128(sv + cc * 16 * 128, kBlockN * 128, 1024),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(s_prev));
  }

"""
_OVERLAP = _cut("  for (int kt = 0; kt < pol.n_tiles; ++kt) {",
                "    if (lane == 0) hopper::mbar_arrive(ring.empty(s));\n  }\n",
                _OVERLAP_LOOP)

def _chain(*edits):
    def fn(text):
        for e in edits:
            text = e(text)
        return text
    return fn


# the two consumer warpgroups take turns to issue their score products
# (FlashAttention-3's ping-pong on named barriers 3 and 4): one's
# softmax runs while the other's products do
_ARRIVE = 'asm volatile("bar.arrive %0, 256;\\n" ::"r"(4 - c) : "memory");'
_PINGPONG = _chain(
    _edit("  for (int kt = 0; kt < pol.n_tiles; ++kt) {",
          '  if (c == 1) asm volatile("bar.arrive 3, 256;\\n" ::: "memory");\n'
          "  for (int kt = 0; kt < pol.n_tiles; ++kt) {"),
    _edit("    const int k0 = kt * kBlockN;\n    if (k0 <= wr.hi) {",
          "    const int k0 = kt * kBlockN;\n"
          '    asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + c) : "memory");\n'
          "    if (k0 <= wr.hi) {"),
    _edit("      hopper::wgmma_commit();\n      hopper::wgmma_wait<0>();\n"
          "      hopper::fence_regs<64>(st);",
          "      hopper::wgmma_commit();\n      " + _ARRIVE + "\n"
          "      hopper::wgmma_wait<0>();\n      hopper::fence_regs<64>(st);"),
    _edit("      hopper::fence_regs<D / 2>(o);\n    }\n    __syncwarp();",
          "      hopper::fence_regs<D / 2>(o);\n    } else {\n      " + _ARRIVE +
          "\n    }\n    __syncwarp();"))


# the overlap with no divergent path around any wgmma: the first tile
# peeled, a uniform loop over the tiles this warpgroup computes, then
# the skipped tiles passed through
_OVERLAP2_LOOP = """  const int n_act = min(pol.n_tiles, wr.hi < 0 ? 0 : wr.hi / kBlockN + 1);
  float alpha[2] = {1.f, 1.f};
  uint32_t pa[8][4];
  // scale, mask, online softmax of one score tile; p packed into pa
  auto softmax = [&](float* st, int k0, int s) {
    float mx[2] = {m[0], m[1]};
    const bool masked = wr.always || k0 + kBlockN - 1 > wr.lo;
    const float* km = pol.key_mask(ring, s);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = (i / 4) * 8 + tig * 2 + (i & 1);
      const int row = (i >> 1) & 1;
      const bool ok = !masked || (k0 + col <= lim[row] && (!km || km[col] > 0.f));
      st[i] = ok ? st[i] * sl2 : kNeg;
      mx[row] = fmaxf(mx[row], st[i]);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = (i >> 1) & 1;
      st[i] = st[i] <= 0.5f * kNeg ? 0.f : hopper::ex2(st[i] - mx[row]);
      sum[row] += st[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha[r] = hopper::ex2(m[r] - mx[r]);
      l[r] = l[r] * alpha[r] + sum[r];
      m[r] = mx[r];
    }
  };
  auto scores = [&](float* st, int s) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const uint32_t off = (j / 4) * kBlockN * 128 + (j % 4) * 32;
      Wgmma<T, 128, 0>::ss(
          st, hopper::desc_sw128(a_q + (j / 4) * kBlockM * 128 + (j % 4) * 32, 16, 1024),
          hopper::desc_sw128(ring.k(s) + off, 16, 1024), j > 0);
    }
  };
  auto pv = [&](int s) {
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      Wgmma<T, D, 1>::rs(
          o, pa[cc], hopper::desc_sw128(ring.v(s) + cc * 16 * 128, kBlockN * 128, 1024),
          1);
  };
  if (n_act > 0) {
    float st[64];
    hopper::mbar_wait(ring.full(0), 0);
    hopper::wgmma_fence();
    scores(st, 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(st);
    softmax(st, 0, 0);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) hopper::pack_a<T>(pa[cc], st, cc);
  }
  for (int kt = 1; kt < n_act; ++kt) {
    const int s = kt % kStages;
    const int sp = (kt - 1) % kStages;
    hopper::mbar_wait(ring.full(s), (kt / kStages) & 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    float st[64];
    hopper::wgmma_fence();
    scores(st, s);
    hopper::wgmma_commit();
    pv(sp);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs<64>(st);
    softmax(st, kt * kBlockN, s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(sp));
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) hopper::pack_a<T>(pa[cc], st, cc);
  }
  if (n_act > 0) {
    const int sp = (n_act - 1) % kStages;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    hopper::wgmma_fence();
    pv(sp);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(sp));
  }
  for (int kt = n_act; kt < pol.n_tiles; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(ring.full(s), (kt / kStages) & 1);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(s));
  }

"""
_OVERLAP2 = _cut("  for (int kt = 0; kt < pol.n_tiles; ++kt) {",
                 "    if (lane == 0) hopper::mbar_arrive(ring.empty(s));\n  }\n",
                 _OVERLAP2_LOOP)

# the overlap with every wgmma outside any branch: both warpgroups run
# every tile (a tile past a warpgroup's rows is all masked: p = 0), and
# the next tile's barrier wait comes before p is packed
_OVERLAP3_LOOP = _OVERLAP2_LOOP.split("  if (n_act > 0) {\n    float st[64];")[0] \
    .replace("  const int n_act = min(pol.n_tiles, wr.hi < 0 ? 0 : wr.hi / kBlockN + 1);\n", "") \
    .replace("const bool masked = wr.always || k0 + kBlockN - 1 > wr.lo;",
             "const bool masked = wr.always || k0 + kBlockN - 1 > wr.lo || k0 > wr.hi;") \
    .replace("const bool ok = !masked || (k0 + col <= lim[row] && (!km || km[col] > 0.f));",
             "const bool ok = !masked || (k0 + col <= lim[row] && k0 <= wr.hi && (!km || km[col] > 0.f));") + """  float st[64];
  hopper::mbar_wait(ring.full(0), 0);
  hopper::wgmma_fence();
  scores(st, 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs<64>(st);
  softmax(st, 0, 0);
  if (pol.n_tiles > 1) hopper::mbar_wait(ring.full(1 % kStages), (1 / kStages) & 1);
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) hopper::pack_a<T>(pa[cc], st, cc);
  for (int kt = 1; kt < pol.n_tiles; ++kt) {
    const int s = kt % kStages;
    const int sp = (kt - 1) % kStages;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    hopper::wgmma_fence();
    scores(st, s);
    hopper::wgmma_commit();
    pv(sp);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs<64>(st);
    softmax(st, kt * kBlockN, s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(sp));
    if (kt + 1 < pol.n_tiles)
      hopper::mbar_wait(ring.full((kt + 1) % kStages), ((kt + 1) / kStages) & 1);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) hopper::pack_a<T>(pa[cc], st, cc);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  hopper::wgmma_fence();
  pv((pol.n_tiles - 1) % kStages);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs<D / 2>(o);
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(ring.empty((pol.n_tiles - 1) % kStages));

"""
_OVERLAP3 = _cut("  for (int kt = 0; kt < pol.n_tiles; ++kt) {",
                 "    if (lane == 0) hopper::mbar_arrive(ring.empty(s));\n  }\n",
                 _OVERLAP3_LOOP)

_HEAD_FASTEST = _edit(
    "    const int bh = blk / n_rt;\n    r0 = (n_rt - 1 - blk % n_rt) * attn_fwd::kBlockM;",
    "    const int bh = blk % (p.B * p.Hkv);\n"
    "    r0 = (n_rt - 1 - blk / (p.B * p.Hkv)) * attn_fwd::kBlockM;")
_NO_SCALES = _edit("val[u] = j < kN && k0 + j < p.cap ? scl[row * p.Hkv + hk]",
                   "val[u] = j < kN && k0 + j < 0 ? scl[row * p.Hkv + hk]")
_NO_CONVERT = _edit("for (int u = ct; u < kN * (D / 16); u += 96) {",
                    "for (int u = ct; u < 0; u += 96) {")

_VQ_NO_CONVERT = _edit(
    "  return hopper::pack2<T>(code(wa, ia) * fa, code(wb, ib) * fb);",
    "  return wa + wb;")
_VQ_NO_SCALES = _edit("          if (j < 2 * kTileN)\n            cp_async4(",
                      "          if (j < 0)\n            cp_async4(")
# the scales loaded to the producer's registers one tile ahead and stored
# by the lanes before their arrival (the first form of the code ring): the
# arrival waits for the next tile's loads
_VQ_SCALES_IN_REGS = _cut(
    "    // ---- producer: lane 0 issues the codes' TMA, lanes 1-31 copy the",
    "      if (i + 1 < n) plan(t0 + i + 1);\n    }\n",
    """    // ---- producer: lane 0 issues the codes' TMA, lanes 1-31 the scales
    constexpr int kPer = (2 * kTileN + 30) / 31;
    // scales of tile kt: j < kTileN the K scale of position j, else the V
    // scale of position j - kTileN
    auto gather = [&](int kt, float* val) {
      const int k0 = kt * kTileN;
      int lg = 0;
      long seg_row = 0;
      if constexpr (kPaged) {
        lg = __ffs(p.seg) - 1;
        const int t = k0 + ((lane - 1) << lg);
        const int bi = t / p.bs;
        if (lane - 1 < (kTileN >> lg))
          seg_row = static_cast<long>(bi < n_blk ? tbl[bi] : 0) * p.bs + (t - bi * p.bs);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = lane - 1 + 31 * u;
        const int pos = j & (kTileN - 1);
        long row;
        if constexpr (kPaged)
          row = __shfl_sync(0xfffffffeu, seg_row, 1 + (pos >> lg)) + (pos & (p.seg - 1));
        else
          row = static_cast<long>(b) * p.cap + k0 + pos;
        const float* scl = j < kTileN ? p.ks : p.vs;
        val[u] = j < 2 * kTileN && k0 + pos < p.cap ? __ldg(scl + row * p.Hkv + hk) : 0.f;
      }
    };
    // one tensor's codes of tile kt: one box (dense) or one a pool segment
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int kt) {
      const int k0 = kt * kTileN;
      if constexpr (kPaged) {
        for (int i = 0; i < kTileN / p.seg; ++i) {
          const int t = k0 + i * p.seg;
          const int bi = t / p.bs;
          const int blk = bi < n_blk ? tbl[bi] : 0;  // the null block past them
          hopper::tma_load_4d(dst + i * p.seg * D, map, bar, 0, hk, t - bi * p.bs, blk);
        }
      } else {
        hopper::tma_load_4d(dst, map, bar, 0, hk, k0, b);
      }
    };
    float cur[kPer], nxt[kPer];
    if (lane != 0 && n > 0) gather(t0, cur);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      // the next tile's scale loads go out before this slot is waited for
      if (lane != 0 && i + 1 < n) gather(t0 + i + 1, nxt);
      if (i >= kStages) hopper::mbar_wait(empty(s), ((i / kStages) - 1) & 1);
      const uint32_t st = base + s * L::kStage;
      if (lane == 0) {
        hopper::mbar_expect_tx(full(s), 2 * L::kCodes);
        load(st, &p.tm_k, full(s), t0 + i);
        load(st + L::kCodes, &p.tm_v, full(s), t0 + i);
      } else {
        float* sc = reinterpret_cast<float*>(sm + s * L::kStage + 2 * L::kCodes);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if (lane - 1 + 31 * u < 2 * kTileN) sc[lane - 1 + 31 * u] = cur[u];
          cur[u] = nxt[u];
        }
        hopper::mbar_arrive(full(s));
      }
    }
""")


def _vq_stages(n):
    return _edit("constexpr int kStages = 3;             // ring depth",
                 f"constexpr int kStages = {n};             // ring depth")


_VQ_WARPS4 = _edit("constexpr int kCons = 8;               // consumer warps",
                   "constexpr int kCons = 4;               // consumer warps")
_VQ_SPLIT2 = _edit("  int ns = sm_count() / pairs;", "  int ns = 2;")
_VQ_NO_CLUSTER = _edit("  int ns = sm_count() / pairs;", "  int ns = 1;")
def _VQ_WALK_EACH(text):
    for var, mask in (("srow[u]", "0xffffffffu"), ("row", "0xfffffffeu")):
        line = (f" {var} = __shfl_sync({mask}, seg_row, 1 + (pos >> lg)) "
                f"+ (pos & (p.seg - 1));")
        if line in text:
            return text.replace(line, (
                " {\n"
                "            const int t = k0 + pos;\n"
                "            const int bi = t / p.bs;\n"
                f"            {var} = static_cast<long>(bi < n_blk ? tbl[bi] : 0)"
                " * p.bs + (t - bi * p.bs);\n"
                "          }"))
    raise SystemExit("variant edit no longer applies: the paged scale row")


# the previous producer order: each tile's pool blocks and scale rows
# worked out after its stage is free
_VQ_PLAN_AFTER_WAIT = _cut(
    "    // ---- producer: lane 0 issues the codes' TMA, lanes 1-31 copy the",
    "      if (i + 1 < n) plan(t0 + i + 1);\n    }\n",
    """    // ---- producer: lane 0 issues the codes' TMA, lanes 1-31 copy the
    // scales by cp.async; both complete on the stage's full barrier, so
    // the warp blocks only on a free stage
    constexpr int kPer = (2 * kTileN + 30) / 31;
    // scales of tile kt into the stage at `dst`: j < kTileN the K scale of
    // position j, else the V scale of position j - kTileN (zero past the
    // capacity)
    auto scales = [&](int kt, uint32_t dst, uint32_t bar) {
      const int k0 = kt * kTileN;
      int lg = 0;
      long seg_row = 0;
      if constexpr (kPaged) {
        lg = __ffs(p.seg) - 1;
        const int t = k0 + ((lane - 1) << lg);
        const int bi = t / p.bs;
        if (lane - 1 < (kTileN >> lg))
          seg_row = static_cast<long>(bi < n_blk ? tbl[bi] : 0) * p.bs + (t - bi * p.bs);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = lane - 1 + 31 * u;
        const int pos = j & (kTileN - 1);
        long row;
        if constexpr (kPaged)
          row = __shfl_sync(0xfffffffeu, seg_row, 1 + (pos >> lg)) + (pos & (p.seg - 1));
        else
          row = static_cast<long>(b) * p.cap + k0 + pos;
        const bool live = k0 + pos < p.cap;
        const float* scl = j < kTileN ? p.ks : p.vs;
        if (j < 2 * kTileN)
          cp_async4(dst + 4 * j, live ? scl + row * p.Hkv + hk : scl, live);
      }
      cp_async_arrive(bar);
    };
    // one tensor's codes of tile kt: one box (dense) or one a pool segment
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int kt) {
      const int k0 = kt * kTileN;
      if constexpr (kPaged) {
        for (int i = 0; i < kTileN / p.seg; ++i) {
          const int t = k0 + i * p.seg;
          const int bi = t / p.bs;
          const int blk = bi < n_blk ? tbl[bi] : 0;  // the null block past them
          hopper::tma_load_4d(dst + i * p.seg * D, map, bar, 0, hk, t - bi * p.bs, blk);
        }
      } else {
        hopper::tma_load_4d(dst, map, bar, 0, hk, k0, b);
      }
    };
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      if (i >= kStages) hopper::mbar_wait(empty(s), ((i / kStages) - 1) & 1);
      const uint32_t st = base + s * L::kStage;
      if (lane == 0) {
        hopper::mbar_expect_tx(full(s), 2 * L::kCodes);
        load(st, &p.tm_k, full(s), t0 + i);
        load(st + L::kCodes, &p.tm_v, full(s), t0 + i);
      } else {
        scales(t0 + i, st + 2 * L::kCodes, full(s));
      }
    }
""")
VQ = "window_attention.cuh"
# the pool's codes through a map of one flat run of positions (block id x
# bs + offset, 2^24 positions) in place of a 4-d map over block ids
_VQ_FLAT_POOL = _chain(
    _edit("  const int nb = kPaged ? (1 << 30) : a.B;\n  const int npos = kPaged ? a.bs : a.S;\n"
          "  p.seg = kPaged && pool_seg(a.bs) < kTileN ? pool_seg(a.bs) : kTileN;",
          "  const int nb = kPaged ? 1 : a.B;\n  const int npos = kPaged ? (1 << 24) : a.S;\n"
          "  p.seg = kPaged && pool_seg(a.bs) < kTileN ? pool_seg(a.bs) : kTileN;"),
    _edit("0, hk, soff[g], sblk[g]);", "0, hk, sblk[g] * p.bs + soff[g], 0);"))

# name: (entry source, file the edit applies to, edit)
VARIANTS = {
    "fwd:stages3": ("flash_fwd.cu", "flash_fwd.cu", _edit(
        "static constexpr int kStages = 2;", "static constexpr int kStages = 3;")),
    "fwd:no_softmax": ("flash_fwd.cu", HEADER, _edit(
        "st[i] = hopper::ex2(st[i] - mx[row]);", "st[i] = st[i] - mx[row];")),
    "fwd:no_scores": ("flash_fwd.cu", HEADER, _NO_SCORES),
    "fwd:no_pv": ("flash_fwd.cu", HEADER, _NO_PV),
    "fwd:overlap": ("flash_fwd.cu", HEADER, _OVERLAP),
    "fwd:pingpong": ("flash_fwd.cu", HEADER, _PINGPONG),
    "fwd:overlap2": ("flash_fwd.cu", HEADER, _OVERLAP2),
    "chunk:overlap2": ("window_attention.cu", HEADER, _OVERLAP2),
    "fwd:overlap3": ("flash_fwd.cu", HEADER, _OVERLAP3),
    "chunk:overlap3": ("window_attention.cu", HEADER, _OVERLAP3),
    "chunk:pingpong": ("window_attention.cu", HEADER, _PINGPONG),
    "chunk:overlap": ("window_attention.cu", HEADER, _OVERLAP),
    "chunk:no_pv": ("window_attention.cu", HEADER, _NO_PV),
    "chunk_q:no_convert": ("window_attention_q.cu", "window_attention.cuh",
                           _NO_CONVERT),
    "pchunk_q:no_convert": ("paged_window_attention_q.cu",
                            "window_attention.cuh", _NO_CONVERT),
    "pchunk_q:no_scales": ("paged_window_attention_q.cu",
                           "window_attention.cuh", _NO_SCALES),
    "chunk_q:no_scales": ("window_attention_q.cu", "window_attention.cuh",
                          _NO_SCALES),
    "fwd:tile_fastest": ("flash_fwd.cu", "flash_fwd.cu", _edit(
        "    const int bh = blk % (p.B * p.H);\n    int qt = blk / (p.B * p.H);",
        "    const int bh = blk / n_qt;\n    int qt = blk % n_qt;")),
    "chunk:head_fastest": ("window_attention.cu", "window_attention.cuh",
                           _HEAD_FASTEST),
    "chunk_q:head_fastest": ("window_attention_q.cu", "window_attention.cuh",
                             _HEAD_FASTEST),
    "pchunk_q:head_fastest": ("paged_window_attention_q.cu",
                              "window_attention.cuh", _HEAD_FASTEST),
    "pchunk_q:no_prefetch": ("paged_window_attention_q.cu",
                             "window_attention.cuh", _chain(
                                 _edit("          if (lane != 0 && i + 1 < n_items) gather(i + 1, nxt);\n", ""),
                                 _edit("            hopper::mbar_wait(ring.bar(kRaw + r), ((i / kRaw) - 1) & 1);\n",
                                       "            hopper::mbar_wait(ring.bar(kRaw + r), ((i / kRaw) - 1) & 1);\n"
                                       "          if (lane != 0 && i + 1 < n_items) gather(i + 1, nxt);\n"))),
    "pchunk_q:walk_each": ("paged_window_attention_q.cu",
                           "window_attention.cuh", _edit(
                               "scl[row * p.Hkv + hk]",
                               "scl[kv_row(tbl, k0 + j) * p.Hkv + hk]")),
    "verify_q:no_convert": ("window_attention_q.cu", VQ, _VQ_NO_CONVERT),
    "pverify_q:no_convert": ("paged_window_attention_q.cu", VQ, _VQ_NO_CONVERT),
    "verify_q:no_scales": ("window_attention_q.cu", VQ, _VQ_NO_SCALES),
    "pverify_q:no_scales": ("paged_window_attention_q.cu", VQ, _VQ_NO_SCALES),
    "verify_q:stages2": ("window_attention_q.cu", VQ, _vq_stages(2)),
    "verify_q:stages4": ("window_attention_q.cu", VQ, _vq_stages(4)),
    "verify_q:stages6": ("window_attention_q.cu", VQ, _vq_stages(6)),
    "pverify_q:stages2": ("paged_window_attention_q.cu", VQ, _vq_stages(2)),
    "pverify_q:stages4": ("paged_window_attention_q.cu", VQ, _vq_stages(4)),
    "verify_q:warps4": ("window_attention_q.cu", VQ, _VQ_WARPS4),
    "verify_q:warps4_stages6": ("window_attention_q.cu", VQ,
                                _chain(_VQ_WARPS4, _vq_stages(6))),
    "verify_q:split2": ("window_attention_q.cu", VQ, _VQ_SPLIT2),
    "verify_q1:no_cluster": ("window_attention_q.cu", VQ, _VQ_NO_CLUSTER),
    "pverify_q1:no_cluster": ("paged_window_attention_q.cu", VQ,
                              _VQ_NO_CLUSTER),
    "pverify_q:walk_each": ("paged_window_attention_q.cu", VQ, _VQ_WALK_EACH),
    "pverify_q:flat_pool": ("paged_window_attention_q.cu", VQ, _VQ_FLAT_POOL),
    "pverify_q:plan_after_wait": ("paged_window_attention_q.cu", VQ,
                                  _VQ_PLAN_AFTER_WAIT),
    "verify_q:plan_after_wait": ("window_attention_q.cu", VQ,
                                 _VQ_PLAN_AFTER_WAIT),
    "verify_q:scales_in_regs": ("window_attention_q.cu", VQ, _VQ_SCALES_IN_REGS),
    "pverify_q:scales_in_regs": ("paged_window_attention_q.cu", VQ,
                                 _VQ_SCALES_IN_REGS),
    "pverify_q:walk_each_in_regs": ("paged_window_attention_q.cu", VQ,
                                    _chain(_VQ_SCALES_IN_REGS, _VQ_WALK_EACH)),
}
# the previous verify design, from a copy of its sources (see above)
BASELINE = ROOT / "build" / "baseline_csrc"
BASELINES = {"verify_q:prev": "window_attention_q.cu",
             "pverify_q:prev": "paged_window_attention_q.cu",
             "verify_q1:prev": "window_attention_q.cu",
             "pverify_q1:prev": "paged_window_attention_q.cu",
             "verify:prev": "window_attention.cu",
             "pverify:prev": "paged_window_attention.cu",
             "chunk:prev": "window_attention.cu",
             "pchunk:prev": "paged_window_attention.cu",
             "chunk_q:prev": "window_attention_q.cu",
             "pchunk_q:prev": "paged_window_attention_q.cu"}
COMMITTED = {"fwd:committed": "flash_fwd.cu",
             "chunk:committed": "window_attention.cu",
             "chunk_q:committed": "window_attention_q.cu",
             "pchunk_q:committed": "paged_window_attention_q.cu",
             "pchunk:committed": "paged_window_attention.cu",
             "verify:committed": "window_attention.cu",
             "pverify:committed": "paged_window_attention.cu",
             "verify_q:committed": "window_attention_q.cu",
             "pverify_q:committed": "paged_window_attention_q.cu",
             "verify_q1:committed": "window_attention_q.cu",
             "pverify_q1:committed": "paged_window_attention_q.cu"}
# C entry point: (symbol, pointer arguments, int arguments)
SYMBOLS = {"flash_fwd.cu": ("flash_fwd", 6, 7),
           "window_attention.cu": ("window_attention", 5, 7),
           "window_attention_q.cu": ("window_attention_q", 7, 7),
           "paged_window_attention.cu": ("paged_window_attention", 6, 8),
           "paged_window_attention_q.cu": ("paged_window_attention_q", 8, 8)}


def build(_build, only=()):
    """Compile the committed sources (of the kernels the named variants
    edit, or all) and every variant (or those named in ``only``), all at
    once; returns {name: (entry source, C function)}."""
    prefixes = {n.split(":")[0] for n in only}
    jobs = {n: (src, None, None, _build.CSRC) for n, src in COMMITTED.items()
            if not only or n.split(":")[0] in prefixes}
    jobs.update({n: (*v, _build.CSRC) for n, v in VARIANTS.items()
                 if not only or n in only})
    for n, src in BASELINES.items():
        if only and n not in only:
            continue
        if BASELINE.is_dir():
            jobs[n] = (src, None, None, BASELINE)
        else:
            cs.log(f"[variants] {n}: no copy of the previous sources in "
                   f"{BASELINE}: skipped")
    procs = {}
    for name, (source, target, edit, src_dir) in jobs.items():
        d = OUT / name.replace(":", "_")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in [source, *(p.name for p in src_dir.glob("*.cuh"))]:
            shutil.copy(src_dir / f, d / f)
        if edit is not None:
            (d / target).write_text(edit((d / target).read_text()))
        lib = d / "lib.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(d / source)]
        procs[name] = (source, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (source, lib, proc) in procs.items():
        log, _ = proc.communicate()
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill stores" not in ln})
        notes = sorted({ln.strip()[:160] for ln in log.splitlines()
                        if "warning" in ln.lower() or "serializ" in ln})
        cs.log(f"[variants] {name}: nvcc exit {proc.returncode}, spills: "
               f"{spills or 'none'}{', ptxas: ' + str(notes) if notes else ''}")
        if proc.returncode:
            raise SystemExit(log)
        symbol, n_ptr, n_int = SYMBOLS[source]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (source, fn)
    return fns


def main():
    cs.phase_device()
    from paddle_tpu_torch.ops import _build
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    fns = build(_build, sys.argv[1:])
    P = _build.ptr
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def flash_inputs(b, s, h, hkv, d):
        q, k, v = (cs._rand(sh, gen) for sh in
                   ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
        return dict(q=q, k=k, v=v, o=torch.empty_like(q),
                    lse=torch.empty((b, h, s), device="cuda"))

    def window(lengths, w, quantized, bs=None):
        t = cs.window_inputs(gen, lengths, w, 16, 16, 128, quantized, bs,
                             spare=0)
        return dict(t=t, o=torch.empty_like(t[0]))

    def run(name, x):
        source, fn = fns[name]
        if source == "flash_fwd.cu":
            q, k = x["q"], x["k"]
            args = (P(q), P(k), P(x["v"]), P(None), P(x["o"]), P(x["lse"]),
                    q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], 1, 0, _build.stream_ptr(q))
        else:
            q, k, v, tables, lens, ks, vs = x["t"]
            scales = (P(ks), P(vs)) if ks is not None else ()
            if tables is None:
                args = (P(q), P(k), P(v), *scales, P(lens), P(x["o"]),
                        q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                        k.shape[2], q.shape[3], 0, _build.stream_ptr(q))
            else:
                args = (P(q), P(k), P(v), *scales, P(tables), P(lens),
                        P(x["o"]), q.shape[0], q.shape[1], tables.shape[1],
                        k.shape[1], q.shape[2], k.shape[2], q.shape[3], 0,
                        _build.stream_ptr(q))
        err = fn(*args)
        if err:
            again = fn(*args)
            raise RuntimeError(f"{name}: launch failed with cudaError {err} "
                               f"(again: {again}; shapes "
                               f"{[tuple(t.shape) for t in x.get('t', ()) if t is not None]})")

    def check(name, x):
        run(name, x)
        if "q" in x:
            ref, _ = fa._flash_plain(x["q"].float(), x["k"].float(),
                                     x["v"].float(), True)
        else:
            ref = cs._window_call(x["t"], plain=True)
        torch.cuda.synchronize()
        return cs.row_errors(x["o"], ref)

    edges = [0, 1, 63, 64, 65, 700, 1500, 2043]
    cases = {"fwd": [flash_inputs(2, 200, 8, 2, 128),
                     flash_inputs(2, 192, 8, 8, 64)],
             "chunk": [window([0, 100, 1536], 512, False)],
             "chunk_q": [window([0, 100, 1536], 512, True)],
             "pchunk_q": [window([0, 100, 1536], 512, True, 128)],
             "pchunk": [window([0, 100, 1536], 512, False, 128)],
             "verify": [window(edges, 5, False)],
             "pverify": [window(edges, 5, False, 128)],
             "verify_q": [window(edges, 5, True)],
             "pverify_q": [window(edges, 5, True, 128),
                           window(edges, 5, True, 16)],
             "verify_q1": [window([2043], 5, True)],
             "pverify_q1": [window([2043], 5, True, 128)]}
    for name in list(fns):
        for x in cases[name.split(":")[0]]:
            try:
                err, worst, ok = check(name, x)
            except RuntimeError as e:
                cs.log(f"[variants] {e}: dropped")
                del fns[name]
                break
            cs.log(f"[variants] {name}: worst row {worst:.3e} "
                   f"{'ok' if ok else 'differs'}")
    shapes = {"fwd": flash_inputs(4, 2048, 16, 16, 128),
              "chunk": window([1536] * 8, 512, False),
              "chunk_q": window([1536] * 8, 512, True),
              "pchunk_q": window([1536] * 8, 512, True, 128),
              "pchunk": window([1536] * 8, 512, False, 128),
              "verify": window([2043] * 8, 5, False),
              "pverify": window([2043] * 8, 5, False, 128),
              "verify_q": window([2043] * 8, 5, True),
              "pverify_q": window([2043] * 8, 5, True, 128),
              "verify_q1": window([2043], 5, True),
              "pverify_q1": window([2043], 5, True, 128)}
    names = list(fns)
    iters = {n: 200 if "verify" in n else 50 for n in names}
    graphs = {n: cs.capture(lambda: run(n, shapes[n.split(":")[0]]), iters[n])
              for n in names}
    times = {n: [] for n in names}
    for rnd in range(3):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            times[name].append(cs.replay_ms(graphs[name], iters[name]))
    for name in names:
        kind = name.split(":")[0]
        what = ("flash B=4 S=2048 H=16 D=128 causal" if kind == "fwd"
                else "window B=8 W=512 8x1536 H=16 D=128" if "chunk" in kind
                else f"verify B={1 if kind.endswith('1') else 8} W=5 "
                     f"2043 cached H=16 D=128")
        what += " bs=128" if kind.startswith("p") else ""
        cs.log(f"[variants] {name} {what}: best {min(times[name]):.4f} ms, "
               f"rounds {[round(x, 4) for x in times[name]]}")


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    main()
