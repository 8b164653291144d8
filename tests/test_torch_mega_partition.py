"""The decode megakernel's split of its four products over the grid, on
the CPU.

``ops.decode_megakernel._partition`` (mirrored by the kernel's ``Part``
in ``csrc/decode_megakernel.cuh``) cuts each product's weight tiles (64
output columns x 64 input rows) into one run per block.  For every
``gpt_configs`` width the megakernel takes (gpt3-125m to gpt3-13b) and
grids of 1, 8, 78, 114 and 132 blocks (SM counts), each product's pieces
must cover every (strip, k-tile) exactly once, be whole k-tiles inside
one chunk of at most 2048 rows, give every block the same bytes to one
weight tile, and index partials the scratch holds.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import pytest

from paddle_tpu_torch.models import gpt_configs

mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")

CONFIGS = ["gpt3-125m", "gpt3-350m", "gpt3-1.3b", "gpt3-6.7b", "gpt3-13b"]
GRIDS = [1, 8, 78, 114, 132]


def _products(cfg):
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    return {"qkv": (h, h + 2 * kvd), "out": (h, h), "up": (h, f),
            "down": (f, h)}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_partition_covers_every_tile_once_and_balances_bytes(name, grid):
    cfg = gpt_configs()[name]
    for what, (k, n) in _products(cfg).items():
        pt = mk._part(k, n, grid)
        pieces = mk._partition(k, n, grid)
        assert len(pieces) == grid
        seen = {}
        per_block = []
        for b, run in enumerate(pieces):
            tiles = 0
            for strip, k0, k1 in run:
                assert 0 <= strip < n // 64, what
                # whole k-tiles, at most 2048 rows, inside one chunk
                assert k0 % 64 == 0 and k1 % 64 == 0 and k0 < k1 <= k, what
                assert k1 - k0 <= 2048, what
                chunk_rows = pt.cl * 64
                assert k0 // chunk_rows == (k1 - 1) // chunk_rows, what
                # the partial this piece writes fits the scratch
                c = strip * (pt.nk // pt.cl) + k0 // chunk_rows
                assert 0 <= b - pt.blk(c * pt.cl) < pt.parts, what
                for kt in range(k0 // 64, k1 // 64):
                    assert (strip, kt) not in seen, (what, strip, kt)
                    seen[strip, kt] = b
                tiles += (k1 - k0) // 64
            per_block.append(tiles)
        assert len(seen) == (n // 64) * (k // 64), what
        # every block streams the same bytes to one 8 KB weight tile
        assert max(per_block) - min(per_block) <= 1, (what, per_block)
        # runs are contiguous: a block's tiles follow the previous block's
        order = [seen[s, kt] for s in range(n // 64) for kt in range(k // 64)]
        assert order == sorted(order), what


@pytest.mark.parametrize("grid", GRIDS)
def test_partition_at_widths_smaller_than_the_grid(grid):
    """A product with fewer tiles than blocks (H = 256): empty runs read
    no partial and write none; pieces still cover every tile once."""
    k, n = 256, 768
    pt = mk._part(k, n, grid)
    pieces = mk._partition(k, n, grid)
    tiles = sorted((s, kt) for run in pieces for s, k0, k1 in run
                   for kt in range(k0 // 64, k1 // 64))
    assert tiles == [(s, kt) for s in range(n // 64) for kt in range(k // 64)]
    counts = [sum((k1 - k0) // 64 for _, k0, k1 in run) for run in pieces]
    assert max(counts) - min(counts) <= 1
    assert all(pt.start(b) <= pt.start(b + 1) for b in range(grid))
