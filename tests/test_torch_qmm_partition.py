"""The int8 matmul kernel's work split and its split-K sums, on the CPU.

``ops.quantized_matmul._qmm_plan`` chooses the launch of
``csrc/quantized_matmul.cu``; ``_Part`` / ``_decode_pieces`` mirror the
decode regime's split (M <= 16: 64-column x 128-byte units, one run a
block) and ``_prefill_items`` the prefill regime's walk (output tiles x
k splits, item i on block i % blocks).  For the four gpt3-1.3b
projections and edge shapes (N = 128, 384; K = 128, 256), at grids of
132, 114 and 16 blocks (SM counts, and a small grid), every unit must be
covered exactly once, blocks must differ by one unit (decode) or one
item (prefill) at most, and each partial must fall inside the workspace
the plan sizes.

The split sums: a numpy emulation of the kernel's reduction (int32
partials per piece or split, added per strip or tile in shuffled orders,
then ``(acc * sx) * sw`` in f32) must equal ``_qmm_plain`` BITWISE in f32
and bf16: integer sums are exact in any order.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt_configs

qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")

GRIDS = [132, 114, 16]


def _projections():
    cfg = gpt_configs()["gpt3-1.3b"]
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    return {"qkv": (h, h + 2 * kvd), "out": (h, h), "up": (h, f),
            "down": (f, h)}


SHAPES = [*_projections().values(), (128, 128), (128, 384), (256, 128),
          (256, 384)]
SHAPE_IDS = [*_projections(), "k128n128", "k128n384", "k256n128",
             "k256n384"]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("k,n", SHAPES, ids=SHAPE_IDS)
def test_decode_split_covers_every_unit_once_and_balances(k, n, grid):
    pt = qm._Part(n, k, 1)
    blocks = qm._qmm_plan(8, n, k, grid)["blocks"]
    assert blocks == min(pt.total, grid)
    plan = qm._qmm_plan(8, n, k, grid)
    runs = qm._decode_pieces(n, k, blocks)
    assert len(runs) == blocks
    seen, per_block = {}, []
    for b, run in enumerate(runs):
        units = 0
        for strip, kt0, kt1, slot in run:
            assert 0 <= strip < n // 64 and 0 <= kt0 < kt1 <= k // 128
            assert 0 <= slot < plan["pieces"]
            for kt in range(kt0, kt1):
                assert (strip, kt) not in seen, (strip, kt)
                seen[strip, kt] = b
            units += kt1 - kt0
        # a run is cut at strip edges only
        assert all(a[0] < c[0] for a, c in zip(run, run[1:]))
        per_block.append(units)
    assert len(seen) == (n // 64) * (k // 128)
    assert max(per_block) - min(per_block) <= 1, per_block
    assert min(per_block) >= 1
    # runs are contiguous, in block order
    order = [seen[s, kt] for s in range(n // 64) for kt in range(k // 128)]
    assert order == sorted(order)
    # a strip's pieces take distinct slots, 0.. in block order
    for s in range(n // 64):
        owners = sorted({seen[s, kt] for kt in range(k // 128)})
        slots = [slot for b in owners for strip, _, _, slot in runs[b]
                 if strip == s]
        assert slots == list(range(len(owners)))
        assert len(owners) == qm._Part(n, k, blocks).pieces(s)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("m", [17, 64, 65, 512, 1000, 4096])
@pytest.mark.parametrize("k,n", SHAPES, ids=SHAPE_IDS)
def test_prefill_items_cover_every_tile_once_and_balance(k, n, m, grid):
    plan = qm._qmm_plan(m, n, k, grid)
    bm = 64 if m <= 64 else 128
    bn, splits = plan["bn"], plan["splits"]
    assert bn in (128, 256) and 1 <= splits <= k // 128
    runs = qm._prefill_items(m, n, k, plan["blocks"], bn, splits)
    tiles = -(-m // bm) * -(-n // bn)
    assert plan["blocks"] == min(tiles * splits, grid)
    seen = set()
    for run in runs:
        for m0, n0, kt0, kt1, split in run:
            assert m0 % bm == 0 and m0 < m and n0 % bn == 0 and n0 < n
            assert kt1 - kt0 >= 1
            for kt in range(kt0, kt1):
                assert (m0, n0, kt) not in seen
                seen.add((m0, n0, kt))
    assert len(seen) == tiles * (k // 128)
    counts = [len(run) for run in runs]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1
    # the workspace holds every split's partial tile; one counter a tile
    if splits > 1:
        assert plan["work_ints"] == tiles * splits * bm * bn
        assert plan["counters"] == tiles
    else:
        assert plan["work_ints"] == plan["counters"] == 0


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("m", [17, 512])
def test_prefill_split_k_where_tiles_fill_less_than_half(m, grid):
    """The plan splits K exactly when the tiles fill less than half the
    grid, never below 4 (64-row tiles) or 16 (128-row) k-tiles a split,
    and never past the grid."""
    for k, n in SHAPES:
        plan = qm._qmm_plan(m, n, k, grid)
        bm = 64 if m <= 64 else 128
        steps = 4 if bm == 64 else 16
        tiles = -(-m // bm) * -(-n // plan["bn"])
        if tiles * 2 >= grid:
            assert plan["splits"] == 1
        else:
            assert plan["splits"] == max(1, min(grid // tiles,
                                                (k // 128) // steps))
        if plan["splits"] > 1:
            assert (k // 128) // plan["splits"] >= steps
            assert tiles * plan["splits"] <= grid


def _operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32))
    qx, sx = qm.quantize_channel(x, axis=1)
    qw, sw = qm.quantize_channel(w, axis=0)
    return qx.numpy(), qw.numpy(), sx.numpy(), sw.numpy()


def _rescale_check(acc, qx, qw, sx, sw):
    y32 = (acc.astype(np.float32) * sx) * sw
    ref32 = qm._qmm_plain(*(torch.from_numpy(a) for a in (qx, qw, sx, sw)),
                          torch.float32)
    assert torch.equal(torch.from_numpy(y32), ref32)
    ref16 = qm._qmm_plain(*(torch.from_numpy(a) for a in (qx, qw, sx, sw)),
                          torch.bfloat16)
    assert torch.equal(torch.from_numpy(y32).to(torch.bfloat16), ref16)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m,k,n,grid", [(8, 2048, 2048, 132),
                                        (16, 8192, 2048, 114),
                                        (1, 256, 384, 16),
                                        (5, 2048, 6144, 132)])
def test_decode_split_sum_equals_plain_bitwise(m, k, n, grid, seed):
    """int32 partials per piece, summed per strip in a shuffled order,
    then the rescale: bitwise the plain version."""
    qx, qw, sx, sw = _operands(m, k, n, seed)
    rng = np.random.RandomState(seed + 100)
    blocks = qm._qmm_plan(m, n, k, grid)["blocks"]
    partials = {}
    for run in qm._decode_pieces(n, k, blocks):
        for strip, kt0, kt1, slot in run:
            cols = slice(strip * 64, strip * 64 + 64)
            ks = slice(kt0 * 128, kt1 * 128)
            partials.setdefault(strip, {})[slot] = (
                qx[:, ks].astype(np.int32) @ qw[ks, cols].astype(np.int32))
    acc = np.zeros((m, n), dtype=np.int32)
    for strip, parts in partials.items():
        for slot in rng.permutation(len(parts)):
            acc[:, strip * 64:strip * 64 + 64] += parts[slot]
    _rescale_check(acc, qx, qw, sx, sw)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,k,n,bn,splits", [(200, 4096, 256, None, None),
                                             (33, 2048, 2048, None, None),
                                             (100, 256, 384, 256, 2)])
def test_prefill_split_sum_equals_plain_bitwise(m, k, n, bn, splits, seed):
    """The prefill regime's k splits (the plan's, or forced: a 256-wide
    tile over N = 384), summed per tile in a shuffled order."""
    qx, qw, sx, sw = _operands(m, k, n, seed)
    rng = np.random.RandomState(seed + 200)
    plan = qm._qmm_plan(m, n, k, 132, bn, splits)
    assert plan["splits"] > 1
    tiles = {}
    for run in qm._prefill_items(m, n, k, plan["blocks"], plan["bn"],
                                 plan["splits"]):
        for m0, n0, kt0, kt1, split in run:
            rows = slice(m0, m0 + (64 if m <= 64 else 128))
            cols = slice(n0, n0 + plan["bn"])
            ks = slice(kt0 * 128, kt1 * 128)
            tiles.setdefault((m0, n0), {})[split] = (
                qx[rows, ks].astype(np.int32) @ qw[ks, cols].astype(np.int32))
    acc = np.zeros((m, n), dtype=np.int32)
    for (m0, n0), parts in tiles.items():
        assert sorted(parts) == list(range(plan["splits"]))
        for split in rng.permutation(len(parts)):
            part = parts[split]
            acc[m0:m0 + part.shape[0], n0:n0 + part.shape[1]] += part
    _rescale_check(acc, qx, qw, sx, sw)
