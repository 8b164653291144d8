"""Variants of the Hopper forward-attention mainloop
(``paddle_tpu_torch/csrc/hopper_attn_fwd.cuh``), of the verify window's
ring (``window_attention.cuh``, ``vq::verify_kernel``) and of the decode
megakernel (``decode_megakernel.cuh``), timed against the committed
kernels on one NVIDIA GPU.

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
- ``verify:stages2`` / ``pverify:stages2``, ``*:warps4_stages6``: the
  16-bit verify ring two deep, or four consumer warps on 64-key tiles six
  deep; ``verify1:`` / ``pverify1:`` time B=1;
- ``verify_q:prev`` / ``pverify_q:prev`` (and ``*1:prev``): the earlier
  int8 verify design (the codes loaded to registers, converted by I2F and
  staged as 16-bit tiles by four warps), and ``verify:prev``,
  ``pverify:prev`` (the 16-bit ``window_kernel``), ``chunk:prev``,
  ``pchunk:prev``, ``chunk_q:prev``,
  ``pchunk_q:prev``: the window kernels outside the int8 verify regime,
  each built from a copy of the previous sources in
  ``build/baseline_csrc/`` when that directory exists (for example
  ``git archive <commit> paddle_tpu_torch/csrc | tar -x
  --strip-components=2 -C build/baseline_csrc``).

The decode megakernel (kinds ``mega:``, ``mega_q:``, ``pmega:``,
``pmega_q:``: dense and paged, bf16 and int8 caches; ``pmega_seq:`` /
``pmega_q_seq:`` over pools whose blocks lie in table order) at
gpt3-1.3b widths, every slot at 2047 cached positions, is checked at B=8
against the plain version and timed with CUDA events around 20
back-to-back launches, three rounds in turns, best reported; ``:prev``
(the previous design, from ``build/baseline_csrc/``) and ``:committed``
also at B=1 and 16:

- ``*:stamps``: each block's per-phase ``%globaltimer`` stamps, printed
  as a per-phase breakdown (span between barrier releases, block work,
  barrier wait); ``mega:prev_stamps`` etc. the same for the previous
  design;
- ``mega:skipN`` (N in 1..5: qkv, attention, out, up, down) and
  ``mega:attn_only``: phases' loads and work skipped (wrong results,
  timing only); ``mega:no_sync``: no grid barriers;
  ``mega:fence_barrier``: full fences around the barrier's atomic;
  ``mega:prev_skipN`` / ``prev_attn_only`` / ``prev_no_sync``: the same
  cuts of the previous design;
- ``*:stages16``: the ring 16 slots deep; ``mega_q:no_scales`` /
  ``pmega_q:no_scales``: no int8 scale copies; ``mega_q:unroll4``: the
  activation fills unrolled four times; ``pmega_seq:no_walk`` /
  ``small_map``: block ids by arithmetic in place of the table walk, a
  pool map of 4096 blocks.

The int8 matmul (kind ``qmm:``, ``quantized_matmul.cu``) at the twelve
gpt3-1.3b shapes of ``chip_smoke.QMM_SHAPES`` (M in {8, 512, 4096} x qkv,
out, up, down; bf16 out): each library is checked against the plain
version (bitwise) at every shape it is timed at, then all are timed in
turns, three rounds, best reported, each round one replay of a CUDA graph
of calls straight into the C entry (200 calls at M=8, 50 at 512, 20 at
4096):

- ``qmm:committed``; ``qmm:prev``: the previous design (``mma.sync``
  m16n8k32 fed by ``cp.async``, no split-K), from
  ``build/baseline_csrc/``;
- ``qmm:dec_stages4`` / ``qmm:dec_stages12``: the decode regime's ring
  4 or 12 stages deep in place of 8 (M=8 only);
- ``qmm:ring_small``: the prefill ring one stage shallower or more (2
  stages of a 128 x 256 tile in place of 3, 3 of 128 x 128 in place of
  5; M > 16 only);
- ``qmm:no_store`` / ``qmm:no_mma`` / ``qmm:no_arrive``: without the
  output stores (the TMA stores of the prefill regime, the stores and
  rescale of the decode regime), the tensor-core products, or the
  arrivals of a split sum (wrong results, timing only: dropped from the
  check, timed anyway);
- ``qmm:direct_store``: the prefill epilogue's first form, stores
  straight from the registers (4 bytes a thread for 16-bit output) in
  place of the staged TMA stores, with the ring of the committed kernel;
- ``qmm:bn128`` / ``qmm:bn256``: every prefill tile 128 or 256 columns
  wide, whatever the plan chose; ``qmm:no_split``: no k split (at the
  shapes the plan splits, M=512 out and down).  These three run the
  committed library with another plan (``_qmm_plan``'s overrides).

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
    _edit("    hopper::mbar_wait(ring.full(s), (kt / kStages) & 1);\n"
          "    if (k0 <= wr.hi) {",
          "    hopper::mbar_wait(ring.full(s), (kt / kStages) & 1);\n"
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

_VQ_NO_CONVERT = _chain(
    _edit("  return hopper::pack2<T>(Code<KV>::at(wa, ia) * fa, "
          "Code<KV>::at(wb, ib) * fb);", "  return wa + wb;"),
    _edit("  const float2 c = Code<KV>::pair(w, i);\n"
          "  return hopper::pack2<T>(c.x * f, c.y * f);", "  return w;"))
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

# ---- the decode megakernel (row 11) ----------------------------------------
MK = "decode_megakernel.cuh"
# kind: (entry source, paged, int8 cache); timed at gpt3-1.3b widths (H=2048,
# 16 heads of 128, F=8192), every slot at 2047 cached positions, B=8 (and
# B=1, 16 for the committed kernels and the baselines)
MEGA_KINDS = {"mega": ("decode_megakernel.cu", False, False),
              "mega_q": ("decode_megakernel_q.cu", False, True),
              "pmega": ("paged_decode_megakernel.cu", True, False),
              "pmega_q": ("paged_decode_megakernel_q.cu", True, True),
              # the paged kernel over a pool whose slots' blocks lie in
              # table order (the dense cache's bytes as blocks of 128):
              # the shuffled pool's cost against the kernel's
              "pmega_seq": ("paged_decode_megakernel.cu", True, False),
              "pmega_q_seq": ("paged_decode_megakernel_q.cu", True, True)}
# the phases between grid barriers, in order, of the previous design
# (``prev_*`` variants, built from the baseline copy)
MEGA_PREV_PHASES = ("qkv", "attention", "out", "x2+LN2", "up", "down",
                    "x_out")
# the committed design's phases (csrc/decode_megakernel.cuh); its timing
# hooks are macros the variants define
MEGA_PHASES = ("qkv", "attention", "out (+x2, LN2 statistics)", "up",
               "down (+x_out)")
# each block's thread 0 writes %globaltimer to a debug area past the
# scratch (16 stamps a block): 0 at the start, 2 i + 1 when phase i's work
# is done (after a block barrier), 2 i + 2 after its grid barrier
_STAMP_MACRO = r"""#define MEGA_STAMP(i)                                                           \
  do {                                                                          \
    __syncthreads();                                                            \
    if (threadIdx.x == 0) {                                                     \
      unsigned long long t_;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                    \
      reinterpret_cast<unsigned long long*>(p.scratch + ((lay.total + 1) & ~1L)) \
          [blockIdx.x * 16 + (i)] = t_;                                        \
    }                                                                           \
  } while (0)
"""


def _mk_prev_stamps(text):
    text = text.replace("namespace mega {\n", "namespace mega {\n" + _STAMP_MACRO, 1)
    text = _edit("  // 1: LN1 row statistics (every block, one warp a slot), then qkv\n",
                 "  MEGA_STAMP(0);\n"
                 "  // 1: LN1 row statistics (every block, one warp a slot), then qkv\n")(text)
    parts = text.split("  grid.sync();\n")
    if len(parts) != 7:
        raise SystemExit("variant edit no longer applies: six grid barriers")
    out = parts[0]
    for i, part in enumerate(parts[1:]):
        out += (f"  MEGA_STAMP({2 * i + 1});\n  grid.sync();\n"
                f"  MEGA_STAMP({2 * i + 2});\n") + part
    return _edit("    p.x_out[i] = decode_attn::from_float<T>(v);\n  }\n}\n",
                 "    p.x_out[i] = decode_attn::from_float<T>(v);\n  }\n"
                 "  MEGA_STAMP(13);\n}\n")(out)


_MK_PREV_SKIP = {
    1: _edit("  gemv_phase<T, KV, Fill::kLn1>(", "  if (false) gemv_phase<T, KV, Fill::kLn1>("),
    2: _edit("it < B * p.Hkv; it += gridDim.x)\n    attend_item",
             "it < 0; it += gridDim.x)\n    attend_item"),
    3: _edit("  gemv_phase<T, KV, Fill::kCopy>(p, smem, p.w_out,",
             "  if (false) gemv_phase<T, KV, Fill::kCopy>(p, smem, p.w_out,"),
    4: _edit("    for (int b = blockIdx.x; b < B; b += gridDim.x) {\n      __syncthreads();",
             "    for (int b = blockIdx.x; b < 0; b += gridDim.x) {\n      __syncthreads();"),
    5: _edit("  gemv_phase<T, KV, Fill::kCopy>(p, smem, p.w_up,",
             "  if (false) gemv_phase<T, KV, Fill::kCopy>(p, smem, p.w_up,"),
    6: _edit("  gemv_phase<T, KV, Fill::kGelu>(", "  if (false) gemv_phase<T, KV, Fill::kGelu>("),
    7: _edit("threadIdx.x; i < total;\n", "threadIdx.x; i < 0;\n"),
}


def _mk_define(*lines):
    """The committed header with its timing hooks defined."""
    def fn(text):
        if "#ifndef MEGA_STAMP" not in text:
            raise SystemExit("variant edit no longer applies: the timing hooks")
        return "".join(f"#define {ln}\n" for ln in lines) + text
    return fn


_MK_STAMPS = _mk_define(
    "MEGA_STAMP(i) do { cons_sync(); if (threadIdx.x == 0) { "
    "unsigned long long t_; "
    'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
    "reinterpret_cast<unsigned long long*>(p.scratch + ((lay.total + 1) & ~1L))"
    "[blockIdx.x * 16 + (i)] = t_; } } while (0)")


def _mk_prev_no_sync(text):
    if text.count("  grid.sync();\n") != 6:
        raise SystemExit("variant edit no longer applies: six grid barriers")
    return text.replace("  grid.sync();\n", "")


# name: (entry source, header edited, edit, sources): the previous design
# with one edit, from the baseline copy; ``mega:prev_skipN`` skips phase N's work
# (keeping every barrier), ``prev_attn_only`` runs the attention phase
# alone, ``prev_no_sync`` drops every grid barrier (wrong results, timing
# only), ``prev_stamps`` writes the per-phase stamps
MEGA_VARIANTS = {}
for _kind, (_src, _, _) in MEGA_KINDS.items():
    MEGA_VARIANTS[f"{_kind}:prev_stamps"] = (_src, MK, _mk_prev_stamps, "baseline")
for _n, _e in _MK_PREV_SKIP.items():
    MEGA_VARIANTS[f"mega:prev_skip{_n}"] = ("decode_megakernel.cu", MK, _e, "baseline")
MEGA_VARIANTS["mega:prev_attn_only"] = (
    "decode_megakernel.cu", MK,
    _chain(*(e for n, e in _MK_PREV_SKIP.items() if n != 2)), "baseline")
MEGA_VARIANTS["mega:prev_no_sync"] = ("decode_megakernel.cu", MK, _mk_prev_no_sync,
                                      "baseline")
# the committed design: ``stamps`` (all four kinds), ``skipN`` (phase N's
# loads and work skipped, N in 1..5), ``attn_only``, ``no_sync``
for _kind, (_src, _, _) in MEGA_KINDS.items():
    MEGA_VARIANTS[f"{_kind}:stamps"] = (_src, MK, _MK_STAMPS, "committed")
for _n in range(1, 6):
    MEGA_VARIANTS[f"mega:skip{_n}"] = (
        "decode_megakernel.cu", MK, _mk_define(f"MEGA_SKIP {1 << (_n - 1)}"),
        "committed")
MEGA_VARIANTS["mega:attn_only"] = ("decode_megakernel.cu", MK,
                                   _mk_define("MEGA_SKIP 29"), "committed")
MEGA_VARIANTS["mega:no_sync"] = ("decode_megakernel.cu", MK,
                                 _mk_define("MEGA_GRID_SYNC 0"), "committed")
# the paged producer, bisected on pools whose blocks lie in table order
# (``*_seq`` kinds): block ids by arithmetic in place of the table walk
# (right on those pools only), a pool map over 4096 blocks in place of
# 2^30, and (int8) no scale copies (wrong results, timing only)
_MK_NO_WALK = _edit("            blk = bi < n_blk ? tbl[bi] : 0;  // the null block past them\n",
                    "            blk = 1 + it.b * p.MB + bi;\n")
_MK_SMALL_MAP = _edit("  const long nb = kPaged ? (1L << 30) : a.B;",
                      "  const long nb = kPaged ? (1L << 12) : a.B;")
_MK_NO_SCALES = _edit("              if (q < kTilePos)\n                window_attn::vq::cp_async4(",
                      "              if (q < 0)\n                window_attn::vq::cp_async4(")
for _kind in ("pmega_seq", "pmega_q_seq"):
    _src = MEGA_KINDS[_kind][0]
    MEGA_VARIANTS[f"{_kind}:no_walk"] = (_src, MK, _MK_NO_WALK, "committed")
    MEGA_VARIANTS[f"{_kind}:small_map"] = (_src, MK, _MK_SMALL_MAP, "committed")
for _kind in ("mega_q", "pmega_q"):
    MEGA_VARIANTS[f"{_kind}:no_scales"] = (MEGA_KINDS[_kind][0], MK, _MK_NO_SCALES,
                                           "committed")
# the activation fills unrolled four times in place of twice (more loads
# in flight, more registers: the int8 instantiations spill)
MEGA_VARIANTS["mega_q:unroll4"] = ("decode_megakernel_q.cu", MK, _edit(
    "#pragma unroll 2\n    for (int e = threadIdx.x; e < B * n8;",
    "#pragma unroll 4\n    for (int e = threadIdx.x; e < B * n8;"), "committed")
# the weight / K/V ring 16 slots deep in place of 8 (128 KB in flight; a
# depth whose tiles do not return to their last owners does not build)
for _kind, (_src, _, _) in MEGA_KINDS.items():
    MEGA_VARIANTS[f"{_kind}:stages16"] = (_src, MK, _edit(
        "constexpr int kStages = 8;", "constexpr int kStages = 16;"), "committed")
# the grid barrier with full fences around its atomic (as cooperative
# groups' grid sync) in place of a release arrival and acquire wait
MEGA_VARIANTS["mega:fence_barrier"] = ("decode_megakernel.cu", MK, _chain(
    _edit('    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\\n"\n'
          '                 : "=r"(old) : "l"(word), "r"(inc) : "memory");\n',
          "    __threadfence();\n    old = atomicAdd(word, inc);\n"),
    _edit("    } while (((old ^ now) & 0x80000000u) == 0);\n  }\n",
          "    } while (((old ^ now) & 0x80000000u) == 0);\n    __threadfence();\n  }\n")),
    "committed")


def _mega_prev_args(x, w, k, v, lens, ks, vs, tables, sms, extra):
    """The C arguments of the previous design's wrapper (split-K chunk
    counts, its scratch), with ``extra`` zeroed floats past the
    scratch."""
    bsz, h = x.shape
    hkv, d = k.shape[2], k.shape[3]
    f = w[8].shape[-1]
    nq = h + 2 * hkv * d

    def chunks(kk, n):
        strips, c = n // 64, 1
        while kk % (2 * c * 64) == 0 and (kk // c > 2048 or strips * c * 2 <= sms):
            c *= 2
        return c
    kq, ko, ku, kd = chunks(h, nq), chunks(h, h), chunks(h, f), chunks(f, h)
    x_out = torch.empty_like(x)
    k_new = torch.empty((bsz, hkv, d), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    total = bsz * (kq * nq + (3 + ko + kd) * h + ku * f)
    scratch = torch.zeros(total + 2 + extra, dtype=torch.float32, device=x.device)
    cap, bs, mb = (k.shape[1], 0, 0) if tables is None else (0, k.shape[1], tables.shape[1])
    dims = [bsz, h, hkv, d, f, cap, bs, mb, kq, ko, ku, kd, 0]
    ptrs = [x, *w, k, v, ks, vs, tables, lens, x_out, k_new, v_new, scratch]
    return ptrs, dims, (x_out, k_new, v_new), scratch, total


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
    "verify:stages2": ("window_attention.cu", VQ, _vq_stages(2)),
    "pverify:stages2": ("paged_window_attention.cu", VQ, _vq_stages(2)),
    "verify:warps4_stages6": ("window_attention.cu", VQ,
                              _chain(_VQ_WARPS4, _vq_stages(6))),
    "pverify:warps4_stages6": ("paged_window_attention.cu", VQ,
                               _chain(_VQ_WARPS4, _vq_stages(6))),
}
QMM = "quantized_matmul.cu"
QMM_H = "quantized_matmul.cuh"  # the kernels' body, shared with the e4m3 source
VARIANTS.update({
    "qmm:dec_stages4": (QMM, QMM_H, _edit("constexpr int kDecStages = 8;",
                                        "constexpr int kDecStages = 4;")),
    "qmm:dec_stages12": (QMM, QMM_H, _edit("constexpr int kDecStages = 8;",
                                         "constexpr int kDecStages = 12;")),
    "qmm:ring_small": (QMM, QMM_H, _edit("constexpr int kSmemBudget = 229376;",
                                       "constexpr int kSmemBudget = 163840;")),
    # work removed (wrong results, timing only): the output stores (the
    # rescale goes with them), the tensor-core products, the arrivals of
    # a split sum (partials still written, each piece rescales alone)
    "qmm:no_store": (QMM, QMM_H, _chain(
        _edit("          hopper::tma_store_2d(&p.tm_y,", "          if (p.M < 0) hopper::tma_store_2d(&p.tm_y,"),
        _edit("          if (row < p.M)\n            store1(",
              "          if (row < p.M && p.M < 0)\n            store1("))),
    "qmm:no_mma": (QMM, QMM_H, _chain(
        _edit("          Cd::template wgmma<BN>(acc, ",
              "          if (p.M < 0) Cd::template wgmma<BN>(acc, "),
        _edit("          Cd::mma(dst[nt], a, b);",
              "          if (p.M < 0) Cd::mma(dst[nt], a, b);"))),
    "qmm:no_arrive": (QMM, QMM_H, _edit(
        "  hopper::named_sync(1, threads);\n  if (leader) {\n",
        "  if (n > 0) return true;\n  hopper::named_sync(1, threads);\n  if (leader) {\n")),
})
# the first form of the prefill epilogue: stores straight from the
# registers, 4 bytes (two 16-bit values) or 8 a thread
_QMM_DIRECT = _chain(
    _cut("    const uint32_t stg = base + R::kStagingAt + cw * kStaging;",
         "        finish(c.n0 + pass * 128, 128, 32);\n      }\n    }\n",
         """#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = c.n0 + 8 * q + 2 * tig;
      if (col >= p.N) continue;
      const float w0 = p.sw[col], w1 = p.sw[col + 1];
      if (r0 < p.M)
        store2(p.y, static_cast<long>(r0) * p.N + col, p.dtype, rescale(acc[4 * q], s0, w0),
               rescale(acc[4 * q + 1], s0, w1));
      if (r0 + 8 < p.M)
        store2(p.y, static_cast<long>(r0 + 8) * p.N + col, p.dtype,
               rescale(acc[4 * q + 2], s1, w0), rescale(acc[4 * q + 3], s1, w1));
    }
"""),
    _edit("// The arrival of one piece of a split sum", """__device__ __forceinline__ void store2(void* y, long idx, int dtype, float a, float b) {
  if (dtype == 0)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + idx) =
        __floats2bfloat162_rn(a, b);
  else if (dtype == 1)
    *reinterpret_cast<__half2*>(static_cast<__half*>(y) + idx) = __floats2half2_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(y) + idx) = make_float2(a, b);
}

// The arrival of one piece of a split sum"""))
VARIANTS["qmm:direct_store"] = (QMM, QMM_H, _QMM_DIRECT)
QMM_CUTS = ("qmm:no_store", "qmm:no_mma", "qmm:no_arrive")
# the committed library under another plan
QMM_PLANS = {"qmm:bn128": dict(bn=128), "qmm:bn256": dict(bn=256),
             "qmm:no_split": dict(splits=1)}
# the previous verify design, from a copy of its sources (see above)
BASELINE = ROOT / "build" / "baseline_csrc"
BASELINES = {"verify_q:prev": "window_attention_q.cu",
             "pverify_q:prev": "paged_window_attention_q.cu",
             "verify_q1:prev": "window_attention_q.cu",
             "pverify_q1:prev": "paged_window_attention_q.cu",
             "verify:prev": "window_attention.cu",
             "pverify:prev": "paged_window_attention.cu",
             "verify1:prev": "window_attention.cu",
             "pverify1:prev": "paged_window_attention.cu",
             "chunk:prev": "window_attention.cu",
             "pchunk:prev": "paged_window_attention.cu",
             "chunk_q:prev": "window_attention_q.cu",
             "pchunk_q:prev": "paged_window_attention_q.cu",
             "qmm:prev": QMM}
COMMITTED = {"fwd:committed": "flash_fwd.cu",
             "chunk:committed": "window_attention.cu",
             "chunk_q:committed": "window_attention_q.cu",
             "pchunk_q:committed": "paged_window_attention_q.cu",
             "pchunk:committed": "paged_window_attention.cu",
             "verify:committed": "window_attention.cu",
             "pverify:committed": "paged_window_attention.cu",
             "verify1:committed": "window_attention.cu",
             "pverify1:committed": "paged_window_attention.cu",
             "verify_q:committed": "window_attention_q.cu",
             "pverify_q:committed": "paged_window_attention_q.cu",
             "verify_q1:committed": "window_attention_q.cu",
             "pverify_q1:committed": "paged_window_attention_q.cu",
             "qmm:committed": QMM}
for _kind, (_src, _, _) in MEGA_KINDS.items():
    BASELINES[f"{_kind}:prev"] = _src
    COMMITTED[f"{_kind}:committed"] = _src
# C entry point: (symbol, pointer arguments, int arguments); the
# megakernels take (pointer array, int array, eps, stream)
SYMBOLS = {"flash_fwd.cu": ("flash_fwd", 6, 7),
           "window_attention.cu": ("window_attention", 5, 7),
           "window_attention_q.cu": ("window_attention_q", 7, 7),
           "paged_window_attention.cu": ("paged_window_attention", 6, 8),
           "paged_window_attention_q.cu": ("paged_window_attention_q", 8, 8),
           QMM: ("quantized_matmul", 7, 9),
           **{src: (src[:-3], None, None) for src, _, _ in MEGA_KINDS.values()}}


def build(_build, only=()):
    """Compile the committed sources (of the kernels the named variants
    edit, or all) and every variant (or those named in ``only``), all at
    once; returns {name: (entry source, C function)}."""
    prefixes = {n.split(":")[0] for n in only}
    jobs = {n: (src, None, None, _build.CSRC) for n, src in COMMITTED.items()
            if not only or n.split(":")[0] in prefixes}
    jobs.update({n: (*v, _build.CSRC) for n, v in VARIANTS.items()
                 if not only or n in only})
    for n, (src, target, edit, where) in MEGA_VARIANTS.items():
        if only and n not in only:
            continue
        if where == "baseline" and not BASELINE.is_dir():
            cs.log(f"[variants] {n}: no copy of the previous sources in "
                   f"{BASELINE}: skipped")
            continue
        jobs[n] = (src, target, edit,
                   BASELINE if where == "baseline" else _build.CSRC)
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
        # -fno-gnu-unique: a function-local static of one template
        # instance stays in its own library (the previous megakernel kept
        # its grid size in one, which one loaded copy would set for all)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
               "-fno-gnu-unique", "-o", str(lib), str(d / source)]
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
        if name == "qmm:prev":      # the previous entry: no workspace, no plan
            n_ptr, n_int = 5, 4
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        if n_ptr is None:
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                           ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + \
                [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (source, fn)
    return fns


def _stamp_spans(stamps, n_phases):
    """Per phase, from one call's stamps [blocks, 16] (ns): the span from
    the previous barrier's release to this one's (medians over blocks),
    the mean and largest work time of a block, and its mean wait at the
    barrier; microseconds."""
    st = stamps.double()
    rel = [st[:, 0].median().item()]
    rows = []
    for i in range(n_phases):
        done = st[:, 2 * i + 1]
        start = st[:, 0] if i == 0 else st[:, 2 * i]
        work = (done - start) / 1e3
        if i + 1 < n_phases:
            after = st[:, 2 * i + 2]
            rel.append(after.median().item())
            wait = ((after - done) / 1e3).mean().item()
        else:
            rel.append(done.max().item())
            wait = 0.0
        rows.append(((rel[-1] - rel[-2]) / 1e3, work.mean().item(),
                     work.max().item(), wait))
    return rows


def mega_main(fns, names):
    """Check each megakernel library at B=8 against the plain version,
    print the stamps variants' per-phase breakdown, then time every
    library in turns (CUDA events around back-to-back launches, three
    rounds, best): B=8, and B=1 and 16 for ``:prev`` and ``:committed``."""
    from paddle_tpu_torch.ops import _build
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    blk = cs.mega_block(gen, 16, 16)
    w = blk._megakernel_weights()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inputs = {}

    def tensors(kind, b):
        if (kind, b) not in inputs:
            _, paged, quant = MEGA_KINDS[kind]
            if kind.endswith("_seq"):
                x, k, v, _, lens, ks, vs = cs.mega_inputs(
                    gen, blk, [2047] * b, quant)
                mb = k.shape[1] // 128

                def pool(t):
                    if t is None:
                        return None
                    return torch.cat([t.new_zeros((1, 128) + t.shape[2:]),
                                      t.reshape((b * mb, 128) + t.shape[2:])])
                k, v, ks, vs = (pool(t) for t in (k, v, ks, vs))
                tables = (1 + torch.arange(b * mb, device="cuda",
                                           dtype=torch.int32)).reshape(b, mb)
                inputs[kind, b] = (x, k, v, tables, lens, ks, vs)
            else:
                inputs[kind, b] = cs.mega_inputs(gen, blk, [2047] * b, quant,
                                                 128 if paged else None)
        return inputs[kind, b]

    def caller(name, b, extra=0):
        kind, var = name.split(":")
        x, k, v, tables, lens, ks, vs = tensors(kind, b)
        if var.startswith("prev"):
            ptrs, dims, outs, scratch, total = _mega_prev_args(
                x, w, k, v, lens, ks, vs, tables, sms, extra)
        else:
            ptrs, dims, outs, scratch, total = mk._launch_args(
                x, w, k, v, lens, ks, vs, tables, extra=extra)
        fn = fns[name][1]
        cp = (ctypes.c_void_p * len(ptrs))(
            *[None if t is None else t.data_ptr() for t in ptrs])
        cd = (ctypes.c_int * len(dims))(*dims)
        eps = ctypes.c_float(blk.ln_1.epsilon)
        stream = _build.stream_ptr(x)

        def call():
            err = fn(cp, cd, eps, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")
        call.keep = (ptrs, cp, cd)
        return call, outs, scratch, total

    for name in names:
        kind = name.split(":")[0]
        call, outs, _, _ = caller(name, 8)
        call()
        x, k, v, tables, lens, ks, vs = tensors(kind, 8)
        ref = mk._mega_plain(x.float(), w, k, v, lens, ks, vs, tables,
                             eps=blk.ln_1.epsilon)
        torch.cuda.synchronize()
        res = [cs.row_errors(g, r) for g, r in zip(outs, ref)]
        cs.log(f"[variants] {name} B=8: worst row "
               f"{max(r[1] for r in res):.3e} "
               f"{'ok' if all(r[2] for r in res) else 'differs'}")
    for name in [n for n in names if n.endswith("stamps")]:
        prev = ":prev_" in name
        phases = MEGA_PREV_PHASES if prev else MEGA_PHASES
        call, _, scratch, total = caller(name, 8, extra=16 * sms * 2)
        rows = []
        for _ in range(5):
            call()
            torch.cuda.synchronize()
            off = (total + 1) // 2 * 2
            rows.append(_stamp_spans(
                scratch[off:off + 32 * sms].view(torch.int64).view(sms, 16).cpu(),
                len(phases)))
        mean = [[sum(r[i][j] for r in rows) / len(rows) for j in range(4)]
                for i in range(len(phases))]
        cs.log(f"[variants] {name} B=8 per-phase breakdown (us, mean of 5 "
               f"calls; span = previous barrier's release to this one's): " +
               "; ".join(f"{ph} span {m[0]:.2f} (block work mean {m[1]:.2f}"
                         f" max {m[2]:.2f}, barrier wait mean {m[3]:.2f})"
                         for ph, m in zip(phases, mean)) +
               f"; total {sum(m[0] for m in mean):.2f}")
    runs = [(n, b) for n in names for b in
            ((1, 8, 16) if n.endswith((":prev", ":committed")) else (8,))]
    calls = {r: caller(*r)[0] for r in runs}
    times = {r: [] for r in runs}
    for rnd in range(3):
        for r in (runs if rnd % 2 == 0 else runs[::-1]):
            times[r].append(cs.cuda_ms(calls[r], iters=20, warmup=3))
    for (name, b) in runs:
        cs.log(f"[variants] {name} B={b} 2047 cached a slot H=2048 D=128: "
               f"best {min(times[name, b]):.4f} ms, rounds "
               f"{[round(x, 4) for x in times[name, b]]}")


def qmm_main(fns, names):
    """Check each int8 matmul library (or plan) bitwise against the plain
    version at the shapes it is timed at, then time all in turns (CUDA
    graphs of calls into the C entry, three rounds, best)."""
    from paddle_tpu_torch.ops import _build
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    operands = {}
    runs = []
    for name in names:
        if name not in fns and name not in QMM_PLANS:
            continue
        for m in (8, 512, 4096):
            if name.startswith("qmm:dec_") and m > 16:
                continue
            if (name in ("qmm:ring_small", "qmm:direct_store")
                    or name in QMM_PLANS) and m <= 16:
                continue
            for k, n in cs.QMM_SHAPES:
                if name == "qmm:no_split" and \
                        qm._qmm_plan(m, n, k, sms)["splits"] == 1:
                    continue
                runs.append((name, m, k, n))
                if (m, k, n) not in operands:
                    operands[m, k, n] = cs.qmm_operands(gen, m, k, n)

    def caller(name, m, k, n):
        qx, qw_t, sx, sw = operands[m, k, n]
        y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        fn = fns["qmm:committed" if name in QMM_PLANS else name][1]
        P = _build.ptr
        if name == "qmm:prev":
            head, tail, keep = (P(qx), P(qw_t), P(sx), P(sw), P(y)), \
                (m, n, k, 0), ()
        else:
            plan = qm._qmm_plan(m, n, k, sms, **QMM_PLANS.get(name, {}))
            work = torch.empty(max(1, plan["work_ints"]), dtype=torch.int32,
                               device="cuda")
            head = (P(qx), P(qw_t), P(sx), P(sw), P(y), P(work), P(counters))
            tail = (m, n, k, 0, plan["blocks"], plan["bn"], plan["splits"],
                    plan["work_ints"], counters.numel())
            keep = (work,)
        keep += (y,)

        def call():
            err = fn(*head, *tail, _build.stream_ptr(qx))
            if err:
                raise RuntimeError(f"{name} M={m} K={k} N={n}: launch failed "
                                   f"with cudaError {err}")
        call.keep = keep
        return call, y

    for name, m, k, n in list(runs):
        call, y = caller(name, m, k, n)
        qx, qw_t, sx, sw = operands[m, k, n]
        ref = qm._qmm_plain(qx, qw_t.t(), sx, sw, torch.bfloat16)
        ok = True
        for _ in range(3):          # repeated launches reduce right too
            y.zero_()
            call()
            torch.cuda.synchronize()
            ok = ok and torch.equal(y, ref)
        if not ok and name in QMM_CUTS:
            cs.log(f"[variants] {name} M={m} K={k} N={n}: differs (work "
                   f"removed: timing only)")
        elif not ok:
            cs.log(f"[variants] {name} M={m} K={k} N={n}: differs from the "
                   f"plain version: dropped")
            runs.remove((name, m, k, n))
    cs.log(f"[variants] qmm: {len(runs)} (library, shape) pairs equal the "
           f"plain version bitwise")
    iters = {8: 200, 512: 50, 4096: 20}
    calls = {r: caller(*r)[0] for r in runs}
    graphs = {}
    for r in runs:
        graphs[r] = cs.capture(calls[r], iters[r[1]])
    times = {r: [] for r in runs}
    for rnd in range(3):
        for r in (runs if rnd % 2 == 0 else runs[::-1]):
            try:
                times[r].append(cs.replay_ms(graphs[r], iters[r[1]]))
            except Exception:
                cs.log(f"[variants] replay of {r} failed")
                raise
    for r in runs:
        name, m, k, n = r
        plan = ("the previous design" if name == "qmm:prev" else
                qm._qmm_plan(m, n, k, sms, **QMM_PLANS.get(name, {})))
        cs.log(f"[variants] {name} M={m} K={k} N={n}: best "
               f"{min(times[r]):.4f} ms, rounds "
               f"{[round(x, 4) for x in times[r]]}; "
               + (plan if isinstance(plan, str) else
                  f"{plan['regime']} blocks={plan['blocks']} bn={plan['bn']} "
                  f"splits={plan['splits']}"))


def main():
    cs.phase_device()
    from paddle_tpu_torch.ops import _build
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    fns = build(_build, sys.argv[1:])
    mega_names = [n for n in fns if n.split(":")[0] in MEGA_KINDS]
    if mega_names:
        mega_main(fns, mega_names)
    for n in mega_names:
        del fns[n]
    qmm_names = [n for n in fns if n.startswith("qmm:")]
    plans = [n for n in (sys.argv[1:] or QMM_PLANS) if n in QMM_PLANS]
    if qmm_names or plans:
        qmm_main(fns, qmm_names + plans)
    for n in qmm_names:
        del fns[n]
    if not fns:
        return
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
             "pverify": [window(edges, 5, False, 128),
                         window(edges, 5, False, 16)],
             "verify_q": [window(edges, 5, True)],
             "pverify_q": [window(edges, 5, True, 128),
                           window(edges, 5, True, 16)],
             "verify_q1": [window([2043], 5, True)],
             "pverify_q1": [window([2043], 5, True, 128)],
             "verify1": [window([2043], 5, False)],
             "pverify1": [window([2043], 5, False, 128)]}
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
              "pverify_q1": window([2043], 5, True, 128),
              "verify1": window([2043], 5, False),
              "pverify1": window([2043], 5, False, 128)}
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
