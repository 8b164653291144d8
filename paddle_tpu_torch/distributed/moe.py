"""Mixture of experts on one GPU (counterpart of
``paddle_tpu/distributed/moe.py``: the router, capacity dispatch, the
stacked expert FFNs, the auxiliary losses and the expert-balance stats,
with every expert on the one device, the JAX package's ``_fn_dense``
path).

Routing is GShard/Switch top-k with a per-group capacity (a group is one
batch row): ``C = ceil(cf * k * S / E)`` slots per expert, filled one
choice at a time, all first choices of the row by position, then the
second choices behind them, and so on.  An assignment past its expert's
capacity is dropped: its combine weight is zero and the residual carries
the token.  The load-balance loss ``E * sum_e(frac_e * mean_prob_e)``
(Switch eq. 4, over the top-1 assignment) and the router z-loss reach
the training loss through ``collect_aux_losses``, which the trainer opens
around its forward.

The JAX package dispatches and combines with one-hot einsums over
``[B, S, E, C]``; the port computes the same function with index ops:

- per (token, choice): the expert id, its capacity position and a keep
  flag (``top_k_gating``);
- the kept tokens are copied into a fixed ``[E, B * C, H]`` buffer (one
  extra sink row takes the dropped assignments' writes);
- the experts run as two batched products over ``[E, B * C, H]``
  (``torch.bmm``);
- each token's output is ``sum_k gate_k * keep_k * ye[slot_k]``.

No shape depends on the data and nothing is read back to the host, so
the layer can be captured in a CUDA graph.  The expert products are
plain matrix products, outside any kernel in the JAX package as well.

Multi-device expert parallelism (the ``ep`` mesh axis, the all-to-all
formulations and their chunking) comes with the multi-device slice.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
from torch import nn

from ..nn import functional as F
from ..nn import initializer as I

__all__ = ["MoELayer", "ExpertParallelFFN", "top_k_gating",
           "collect_aux_losses", "add_aux_loss", "moe_capacity",
           "collect_expert_stats", "record_expert_stats",
           "fold_expert_stats"]

# ---- auxiliary losses ------------------------------------------------------
_AUX_STACK: List[list] = []


@contextlib.contextmanager
def collect_aux_losses():
    """Collect the auxiliary losses (router load balance, z-loss) that
    layers produce during a forward.  Yields the list the caller adds to
    the training loss."""
    bucket: list = []
    _AUX_STACK.append(bucket)
    try:
        yield bucket
    finally:
        _AUX_STACK.pop()


def add_aux_loss(loss):
    """Layers call this with a scalar tensor; it lands in the innermost
    open collector (nothing happens when none is open)."""
    if _AUX_STACK:
        _AUX_STACK[-1].append(loss)


def moe_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Expert capacity per token group (Switch: cf * k * S / E)."""
    return max(1, int(math.ceil(
        capacity_factor * top_k * tokens_per_group / num_experts)))


# ---- expert-balance stats --------------------------------------------------
_EXPERT_STATS_STACK: List[list] = []


@contextlib.contextmanager
def collect_expert_stats():
    """Collect the per-layer expert-balance records (kept-token load
    ``[E]`` on the device, the assigned count on the host) of the MoE
    layers a forward runs.  Yields the list; fold it with
    ``fold_expert_stats``."""
    bucket: list = []
    _EXPERT_STATS_STACK.append(bucket)
    try:
        yield bucket
    finally:
        _EXPERT_STATS_STACK.pop()


def record_expert_stats(load, assigned: int):
    """MoE layers call this with their kept-token counts per expert
    ``load [E]`` and the number of (token, expert) assignments the router
    made (``top_k * B * S``, known from shapes); dropped = assigned -
    sum(load).  Nothing happens when no collector is open."""
    if _EXPERT_STATS_STACK:
        _EXPERT_STATS_STACK[-1].append(
            {"load": load, "assigned": int(assigned)})


def fold_expert_stats(bucket):
    """Sum a collector's records into ``{"load": [E] f32 tensor,
    "assigned": float}`` (device sums, no host read); None when the
    forward ran no MoE layer."""
    if not bucket:
        return None
    load = bucket[0]["load"].float()
    for rec in bucket[1:]:
        load = load + rec["load"].float()
    return {"load": load,
            "assigned": float(sum(r["assigned"] for r in bucket))}


# ---- the router ------------------------------------------------------------
def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int,
                 normalize_gates: bool = True):
    """Top-k gating with a capacity per group (one batch row).

    logits ``[B, S, E]``.  Returns ``(expert [B, S, k] int64, pos
    [B, S, k] int64, keep [B, S, k] bool, gates [B, S, k] f32, aux,
    zloss)``: choice j of token s goes to expert ``expert[b, s, j]`` at
    capacity slot ``pos[b, s, j]`` when ``keep`` (``pos < capacity``),
    weighted by ``gates`` (renormalized over the k choices when
    ``normalize_gates``); ``aux`` is the Switch load-balance loss over the
    top-1 assignment, ``zloss = mean(logsumexp(logits)^2)``.  The JAX
    package's ``dispatch[b, s, e, c]`` is 1 exactly where ``keep`` and
    ``(e, c) == (expert, pos)``; its ``combine`` holds ``gates`` there."""
    f32 = logits.float()
    probs = torch.softmax(f32, dim=-1)                          # [B, S, E]
    n_experts = probs.shape[-1]
    ids = torch.arange(n_experts, device=probs.device)
    experts, masks, gates = [], [], []
    remaining = probs
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                   # [B, S]
        m = (idx[..., None] == ids).to(torch.float32)           # [B, S, E]
        experts.append(idx)
        masks.append(m)
        gates.append(torch.gather(probs, -1, idx[..., None])[..., 0])
        remaining = remaining * (1.0 - m)

    # load balance from the top-1 assignment (Switch eq. 4)
    load_frac = masks[0].mean(dim=1)                            # [B, E]
    mean_prob = probs.mean(dim=1)                               # [B, E]
    aux = n_experts * (load_frac * mean_prob).sum(dim=-1).mean()
    zloss = torch.logsumexp(f32, dim=-1).square().mean()

    if normalize_gates and top_k > 1:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]

    # capacity positions: choice j's rank among the row's choice-j
    # assignments to the same expert, behind every earlier choice's fill
    positions = []
    offset = torch.zeros(probs.shape[0], 1, n_experts, dtype=torch.int64,
                         device=probs.device)
    for idx, m in zip(experts, masks):
        mi = m.to(torch.int64)
        pos_e = torch.cumsum(mi, dim=1) - mi + offset           # [B, S, E]
        offset = offset + mi.sum(dim=1, keepdim=True)
        positions.append(torch.gather(pos_e, -1, idx[..., None])[..., 0])
    expert = torch.stack(experts, dim=-1)
    pos = torch.stack(positions, dim=-1)
    return (expert, pos, pos < capacity, torch.stack(gates, dim=-1), aux,
            zloss)


# ---- layers ----------------------------------------------------------------
class ExpertParallelFFN(nn.Module):
    """E stacked FFN experts: ``w_up [E, H, F]``, ``b_up [E, F]``,
    ``w_down [E, F, H]``, ``b_down [E, H]`` (the JAX package's names and
    layout); expert e computes ``down(act(up(x_e)))`` over its capacity
    rows."""

    def __init__(self, num_experts: int, hidden_size: int, ffn_size: int,
                 weight_init: Optional[I.Initializer] = None,
                 down_weight_init: Optional[I.Initializer] = None, *,
                 device=None, dtype=torch.float32, generator=None,
                 ep_axis: str = "ep", activation: str = "gelu"):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {activation}")
        self.num_experts = num_experts
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size
        self.ep_axis = ep_axis
        self.activation = activation
        init = weight_init or I.Normal(0.0, 0.02)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.w_up = I.make_parameter((num_experts, hidden_size, ffn_size),
                                     init, **kw)
        self.b_up = I.make_parameter((num_experts, ffn_size), 0.0, **kw)
        self.w_down = I.make_parameter((num_experts, ffn_size, hidden_size),
                                       down_weight_init or init, **kw)
        self.b_down = I.make_parameter((num_experts, hidden_size), 0.0, **kw)

    def act(self, x):
        if self.activation == "gelu":
            return F.gelu(x, approximate=True)
        return torch.relu(x)

    def forward(self, xe: torch.Tensor) -> torch.Tensor:
        """``xe [E, N, H]`` -> ``[E, N, H]`` in ``xe``'s dtype."""
        dt = xe.dtype
        h1 = self.act(torch.bmm(xe, self.w_up.to(dt))
                      + self.b_up.to(dt)[:, None, :])
        return torch.bmm(h1, self.w_down.to(dt)) + self.b_down.to(dt)[:, None, :]


class MoELayer(nn.Module):
    """Switch/GShard MoE layer: router, expert FFNs, combine.  A drop-in
    for an MLP: ``forward(x [B, S, H]) -> [B, S, H]``.  The router's aux
    losses (times ``aux_loss_coeff`` / ``z_loss_coeff``) go to
    ``add_aux_loss`` and, detached, to ``last_aux_loss``; the kept-token
    load per expert to ``record_expert_stats``."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_coeff: float = 0.01, z_loss_coeff: float = 0.0,
                 normalize_gates: bool = True, ep_axis: str = "ep",
                 weight_init: Optional[I.Initializer] = None,
                 down_weight_init: Optional[I.Initializer] = None,
                 activation: str = "gelu",
                 a2a_chunks: Optional[int] = None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_coeff = aux_loss_coeff
        self.z_loss_coeff = z_loss_coeff
        self.normalize_gates = normalize_gates
        self.ep_axis = ep_axis
        self.a2a_chunks = a2a_chunks
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate = I.make_parameter((hidden_size, num_experts),
                                     weight_init or I.Normal(0.0, 0.02), **kw)
        self.experts = ExpertParallelFFN(
            num_experts, hidden_size, ffn_size, weight_init, down_weight_init,
            ep_axis=ep_axis, activation=activation, **kw)
        self.last_aux_loss: Optional[torch.Tensor] = None

    def _fn_dense(self, x: torch.Tensor):
        """``(y, aux, zloss, load [E] f32)``: the JAX package's
        ``_fn_dense`` by index ops.  The router runs in f32; the gates are
        rounded to ``x``'s dtype, as the JAX combine tensor is; the
        experts run in ``x``'s dtype."""
        b, s, h = x.shape
        n_exp, k = self.num_experts, self.top_k
        cap = moe_capacity(s, n_exp, k, self.capacity_factor)
        logits = torch.matmul(x.float(), self.gate.float())
        expert, pos, keep, gates, aux, zloss = top_k_gating(
            logits, k, cap, self.normalize_gates)
        keep_f = keep.to(torch.float32)
        load = torch.zeros(n_exp, dtype=torch.float32, device=x.device
                           ).scatter_add_(0, expert.reshape(-1),
                                          keep_f.reshape(-1))
        # row (e, b, c) of the [E, B * C] buffer; dropped choices write
        # into the sink row E * B * C
        rows = torch.arange(b, device=x.device)[:, None, None]
        slot = (expert * b + rows) * cap + pos
        sink = n_exp * b * cap
        slot = torch.where(keep, slot, sink).reshape(-1)         # [B S k]
        src = x[:, :, None, :].expand(b, s, k, h).reshape(-1, h)
        buf = x.new_zeros(sink + 1, h).index_copy(0, slot, src)
        ye = self.experts(buf[:sink].view(n_exp, b * cap, h))
        # dropped choices read row 0 at weight 0
        picked = ye.reshape(sink, h).index_select(
            0, torch.where(keep.reshape(-1), slot, 0)).view(b, s, k, h)
        w = (gates * keep_f).to(x.dtype)
        y = (w.float()[..., None] * picked.float()).sum(dim=2).to(x.dtype)
        return y, aux, zloss, load

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.a2a_chunks not in (None, 1):
            # one device has no all-to-all to chunk; ignoring an explicit
            # K would hand an A/B measurement the monolithic numbers
            raise NotImplementedError(
                f"a2a_chunks={self.a2a_chunks} only applies to the "
                f"shard_map expert-parallel formulations (the '"
                f"{self.ep_axis}' axis bound inside shard_map, or the "
                f"serving dispatch on an ep>1 mesh); the single-device "
                f"dispatch has no all-to-all to chunk — leave "
                f"a2a_chunks=None")
        y, aux, zloss, load = self._fn_dense(x)
        record_expert_stats(load, self.top_k * x.shape[0] * x.shape[1])
        total_aux = aux * self.aux_loss_coeff
        if self.z_loss_coeff:
            total_aux = total_aux + zloss * self.z_loss_coeff
        self.last_aux_loss = total_aux.detach()
        add_aux_loss(total_aux)
        return y
