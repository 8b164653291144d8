"""Knob-axis registry, shared by the doctor's actions and the autotune
controller (counterpart of ``paddle_tpu/autotune/knobs.py``).

A verdict's structured ``action`` names a ``param``; this module maps it
to a :class:`KnobAxis`: the run kinds it applies to, default candidates,
its environment knob and the tuning-table op a winner commits under.
The registry is the JAX package's, so every doctor action resolves.
Four axes have no single-GPU meaning in the port and stay out of the
controller's default axes (``eligible``): ``use_flash`` (a CUDA tensor
goes to the attention kernels or raises: there is no other path to
trial), ``scan`` (a JAX compile-time layer loop; the port is eager), and
``overlap`` / ``moe_a2a_chunks`` (collectives of a multi-device mesh).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["KnobAxis", "AXES", "axis_for", "axis_for_action",
           "NOT_ON_ONE_GPU", "eligible"]


class KnobAxis:
    """One tunable coordinate; ``name`` is the config key the measure
    function understands.  ``candidates`` are the default trial values
    (an action's non-empty candidate list wins); ``table_op`` the tuning
    table op a winner commits under (None: config only);
    ``hot_apply``: a live engine may apply it without a restart."""

    def __init__(self, name: str, kinds: Tuple[str, ...],
                 candidates: Sequence[Any] = (),
                 env: Optional[str] = None,
                 table_op: Optional[str] = None,
                 hot_apply: bool = False):
        self.name = name
        self.kinds = kinds
        self.candidates = list(candidates)
        self.env = env
        self.table_op = table_op
        self.hot_apply = hot_apply

    def trial_values(self, incumbent: Any,
                     suggested: Optional[Sequence[Any]] = None
                     ) -> List[Any]:
        """Values to trial: the action's suggestion over the defaults,
        minus the incumbent."""
        vals = list(suggested) if suggested else list(self.candidates)
        return [v for v in vals if v != incumbent]

    def __repr__(self):  # pragma: no cover - debug aid
        return f"KnobAxis({self.name!r}, kinds={self.kinds})"


AXES: Dict[str, KnobAxis] = {a.name: a for a in [
    # -- train ----------------------------------------------------------
    KnobAxis("remat_policy", ("train",),
             candidates=["off", "dots_no_batch", "dots", "full"],
             table_op="remat_policy"),
    KnobAxis("quantize", ("train",),
             candidates=[None, "int8"], env="BENCH_QUANTIZE",
             table_op="qmm_tiles"),
    KnobAxis("use_flash", ("train",),
             candidates=[True, False], table_op="flash_blocks"),
    KnobAxis("scan", ("train",), candidates=[True, False]),
    KnobAxis("overlap", ("train",), candidates=[True, False],
             env="PADDLE_TPU_OVERLAP"),
    KnobAxis("moe_a2a_chunks", ("train",), candidates=[1, 2, 4, 8],
             env="PADDLE_TPU_MOE_A2A_CHUNKS",
             table_op="moe_a2a_chunks"),
    KnobAxis("prefetch_depth", ("train",), candidates=[0, 2, 4, 8],
             env="PADDLE_TPU_PREFETCH_DEPTH"),
    # -- serve ----------------------------------------------------------
    KnobAxis("spec_k", ("serve",), candidates=[0, 2, 4],
             env="PADDLE_TPU_SPEC_K"),
    KnobAxis("kv_dtype", ("serve",), candidates=["dense", "int8"],
             env="PADDLE_TPU_KV_DTYPE"),
    KnobAxis("decode_megakernel", ("serve",), candidates=[False, True],
             env="PADDLE_TPU_DECODE_MEGAKERNEL",
             table_op="megakernel_blocks"),
    KnobAxis("megakernel_blocks", ("serve",), candidates=[],
             env="PADDLE_TPU_MEGAKERNEL_BLOCKS",
             table_op="megakernel_blocks"),
    KnobAxis("prefill_buckets", ("serve",), candidates=[],
             env="PADDLE_TPU_PREFILL_BUCKETS",
             table_op="prefill_buckets", hot_apply=True),
    KnobAxis("qmm_tiles", ("train", "serve"), candidates=[],
             table_op="qmm_tiles"),
    KnobAxis("flash_blocks", ("train", "serve"), candidates=[],
             table_op="flash_blocks"),
    KnobAxis("batch_slots", ("serve",), candidates=[],
             env="PADDLE_TPU_DECODE_SLOTS"),
    KnobAxis("prefix_cache", ("serve",), candidates=[True],
             env="PADDLE_TPU_PREFIX_CACHE"),
    KnobAxis("prefill_chunk", ("serve",), candidates=[0, 32, 64, 128],
             env="PADDLE_TPU_CHUNKED_PREFILL", hot_apply=True),
]}

# axes the controller never trials by default on one GPU (see above)
NOT_ON_ONE_GPU = ("use_flash", "scan", "overlap", "moe_a2a_chunks")


def eligible(kind: str) -> List[str]:
    """The controller's default axes for a run kind: every registry axis
    of that kind except ``NOT_ON_ONE_GPU``."""
    return [n for n, a in AXES.items()
            if kind in a.kinds and n not in NOT_ON_ONE_GPU]


def axis_for(param: Optional[str]) -> Optional[KnobAxis]:
    """Registry lookup by param name (None or unknown: None)."""
    if not param:
        return None
    return AXES.get(param)


def axis_for_action(action: Optional[dict]) -> Optional[KnobAxis]:
    """The axis a verdict's action points at: None for behavioral
    advice (param None) or an unknown param."""
    if not isinstance(action, dict):
        return None
    return axis_for(action.get("param"))
