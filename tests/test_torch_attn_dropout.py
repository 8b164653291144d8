"""Attention dropout in the port against the JAX package, on the CPU.

The JAX package drops attention probabilities in its composite
(``nn/functional/attention.py:_sdpa_reference``: ``bernoulli(key, 1 - p)``
after the softmax, then ``/ (1 - p)``); the port draws Philox4x32-10 bits
of a (seed, offset) pair inside its flash kernels, and on the CPU in
their plain versions (``ops/_philox.py``).  The two generators give other
bits, so the ops are held to JAX with JAX's own mask fed to the port's
plain versions as ``keep``.  Tolerances, per output, of its max |JAX|:
- f32: 1e-5 (f32 rounding of the products and the softmax, JAX matmuls
  at highest precision, tests/conftest.py);
- bf16: 2e-2: JAX rounds the probabilities to bf16 before the dropout
  scale and again after it, and its products and gradients come out in
  bf16, where the port keeps f32 until its outputs (2^-8 = 3.9e-3 a
  rounding, a few of them in series).

The Philox words are held to Random123's known answers, the keep bits
to the kernels' own index arithmetic (emulated here tile by tile, as the
forward, dq and dk/dv kernels draw them) and to binomial bounds.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nn.functional.attention import _sdpa_reference

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.ops import _philox

tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64)
U32 = 0xFFFFFFFF


def _close(got, ref, rel, name=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{name}: max err {err:.3e} > {rel} x {scale:.3e}"


# ---- Philox ----------------------------------------------------------------
@pytest.mark.parametrize("ctr_key,words", [
    ((0, 0, 0, 0, 0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((U32,) * 6, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344, 0xa4093822,
      0x299f31d0), (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))],
    ids=["zeros", "ones", "pi"])
def test_philox_known_answer_words(ctr_key, words):
    """Random123's kat_vectors for philox4x32_10."""
    got = _philox.philox4x32_10(*ctr_key)
    assert [int(w) for w in got] == list(words)


def _row_bits(w, thr):
    """philox.cuh Dropout::row_bits: bit 4 g + e <- word (e & 1) * 2 +
    (e >> 1), half g."""
    order = (0, 2, 1, 3)
    bits = 0
    for g in range(2):
        for e in range(4):
            field = (w[order[e]] >> (16 * g)) & 0xFFFF
            bits = bits | ((field >= thr).long() << (4 * g + e))
    return bits


def _col_bits(a0, a1, b0, b1, thr):
    """philox.cuh Dropout::col_bits."""
    parts = ((a0, 0), (b0, 0), (a0, 1), (b0, 1),
             (a1, 0), (b1, 0), (a1, 1), (b1, 1))
    bits = 0
    for n, (w, half) in enumerate(parts):
        bits = bits | ((((w >> (16 * half)) & 0xFFFF) >= thr).long() << n)
    return bits


def _call(pair, bh, i, j):
    return _philox.philox4x32_10(
        (j >> 4) * 32 + (i & 7) * 4 + ((j >> 1) & 3), i >> 4, bh,
        int(pair[1]), int(pair[0]), int(pair[0]) >> 32)


def _rows_tile(pair, bh, q0, k0, rows, keys, thr):
    """One tile's bits as the forward (rows 128, keys 128) or dq (rows
    192, keys 64) kernel draws them: each thread (warp w of its 64-row
    warpgroup, gid, tig) one call per two 8-key groups, bits accumulated
    in the accumulator's element order, then read back per element."""
    tile = torch.zeros(rows, keys, dtype=torch.bool)
    gid = torch.arange(8)[:, None]
    tig = torch.arange(4)[None, :]
    for w16 in range(rows // 16):         # warpgroup c, warp: 16 rows each
        r0 = w16 * 16 + gid
        mask = [torch.zeros(8, 4, dtype=torch.long) for _ in range(2)]
        for g2 in range(keys // 16):
            bits = _row_bits(_call(pair, bh, q0 + r0, k0 + 16 * g2 + 2 * tig),
                             thr)
            mask[g2 >> 2] = mask[g2 >> 2] | (bits << (8 * (g2 & 3)))
        for i in range(keys // 2):       # accumulator element i
            n, e = i // 4, i & 3
            bit = (mask[i >> 5] >> (i & 31)) & 1
            rr = r0 + 8 * (e >> 1)
            cc = 8 * n + 2 * tig + (e & 1)
            tile[rr.expand(8, 4), cc.expand(8, 4)] = bit.bool()
    return tile


def _dkv_tile(pair, bh, q0, k0, thr):
    """One dk/dv tile (keys 128 of two warpgroups, queries 64): rows are
    keys; a thread draws the call of its query column gid & 1 and swaps
    half of it with the lane four away (gid ^ 1)."""
    tile = torch.zeros(64, 128, dtype=torch.bool)   # [queries, keys]
    gid = torch.arange(8)[:, None]
    tig = torch.arange(4)[None, :]
    odd = gid & 1
    for w16 in range(128 // 16):
        kr0 = k0 + w16 * 16 + gid
        mask = torch.zeros(8, 4, dtype=torch.long)
        for g2 in range(64 // 16):
            w = _call(pair, bh, q0 + 16 * g2 + 2 * tig + odd, kr0)
            mine = [torch.where(odd == 1, w[2], w[0]),
                    torch.where(odd == 1, w[3], w[1])]
            send = [torch.where(odd == 1, w[0], w[2]),
                    torch.where(odd == 1, w[1], w[3])]
            got = [s[(gid ^ 1)[:, 0]] for s in send]   # shfl_xor 4
            a = [torch.where(odd == 1, got[x], mine[x]) for x in range(2)]
            b = [torch.where(odd == 1, mine[x], got[x]) for x in range(2)]
            mask = mask | (_col_bits(a[0], a[1], b[0], b[1], thr)
                           << (8 * g2))
        for i in range(32):
            n, e = i // 4, i & 3
            bit = (mask >> i) & 1
            kk = kr0 - k0 + 8 * (e >> 1)
            qq = 8 * n + 2 * tig + (e & 1)
            tile[qq.expand(8, 4), kk.expand(8, 4)] = bit.bool()
    return tile


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_keep_bits_do_not_depend_on_the_tiling(kernel):
    """Bits assembled tile by tile in each kernel's tiling and fragment
    order equal the whole-matrix bits (S = 200: a ragged last tile; G =
    2: the dk/dv kernel redraws each query head of its group)."""
    b, h, hkv, s, p = 1, 4, 2, 200, 0.1
    pair = torch.tensor([0x1234_5678_9abc_def0, 77], dtype=torch.int64)
    thr = _philox.threshold(p)
    rows, keys = {"fwd": (128, 128), "dq": (192, 64), "dkv": (64, 128)}[kernel]
    pad = -(-s // 192) * 192
    whole = _philox.keep_mask(pair, b, h, pad, pad, p)
    got = torch.zeros(b, h, pad, pad, dtype=torch.bool)
    for bi in range(b):
        for hk in range(hkv):
            for g in range(h // hkv):
                hh = hk * (h // hkv) + g
                bh = bi * h + hh
                for q0 in range(0, s, rows):
                    for k0 in range(0, s, keys):
                        if kernel == "dkv":
                            t = _dkv_tile(pair, bh, q0, k0, thr)
                        else:
                            t = _rows_tile(pair, bh, q0, k0, rows, keys, thr)
                        got[bi, hh, q0:q0 + rows, k0:k0 + keys] = t
    assert torch.equal(got[..., :s, :s], whole[..., :s, :s])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_binomial_bounds(p):
    """The kept share of 2 x 8 x 256 x 256 elements, and of each query
    row, against Binomial(n, 1 - p) at 5 sigma; the threshold makes the
    rate exact to 2^-16; other pairs give other masks."""
    b, h, s = 2, 8, 256
    pair = torch.tensor([987654321987, 4242], dtype=torch.int64)
    keep = _philox.keep_mask(pair, b, h, s, s, p)
    n = keep.numel()
    q = 1.0 - _philox.threshold(p) / 65536
    assert abs(q - (1 - p)) <= 2 ** -17
    sigma = (n * q * (1 - q)) ** 0.5
    assert abs(keep.sum().item() - n * q) <= 5 * sigma
    rows = keep.sum(-1).double()
    sig_row = (s * q * (1 - q)) ** 0.5
    assert ((rows - s * q).abs() <= 6 * sig_row).all()
    other = _philox.keep_mask(pair + torch.tensor([0, 1]), b, h, s, s, p)
    agree = (other == keep).double().mean().item()
    assert abs(agree - (q * q + (1 - q) * (1 - q))) < 0.01


# ---- the ops against the JAX composite ---------------------------------------
CASES = [(True, False, 1, "float32"), (True, True, 2, "float32"),
         (False, True, 1, "bfloat16"), (True, False, 2, "bfloat16")]


@pytest.mark.parametrize("causal,masked,g,dtype", CASES,
                         ids=["causal-f32", "causal-mask-gqa2-f32",
                              "full-mask-bf16", "causal-gqa2-bf16"])
def test_plain_forward_and_grads_match_jax_under_its_mask(causal, masked, g,
                                                          dtype):
    b, s, hkv, d, p = 2, 40, 2, 16, 0.25
    h = hkv * g
    rng = np.random.RandomState(g + 10 * masked)
    q, k, v, do = (rng.randn(b, s, n, d).astype(np.float32)
                   for n in (h, hkv, hkv, h))
    kv_mask = None
    if masked:
        kv_mask = (rng.rand(b, s) > 0.3).astype(np.float32)
        kv_mask[:, 0] = 1.0           # no query row without a key
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p, (b, h, s, s)))
    jdt = jnp.dtype(dtype)

    def jf(q, k, v):
        ke, ve = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        bias = None if kv_mask is None else jnp.where(
            jnp.asarray(kv_mask)[:, None, None, :] > 0, 0.0, -1e30
        ).astype(jnp.float32)
        return _sdpa_reference(q, ke, ve, bias, p, causal, None, key)

    jargs = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jo, vjp = jax.vjp(jf, *jargs)
    jgrads = vjp(jnp.asarray(do).astype(jdt))

    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tm = None if kv_mask is None else torch.from_numpy(kv_mask)
    tkeep = torch.from_numpy(keep)
    o, lse = tfa._flash_plain(tq, tk, tv, causal, tm, p, keep=tkeep)
    grads = tfa._flash_bwd_plain(tq, tk, tv, o, lse, tdo, causal, tm, p,
                                 keep=tkeep)
    tol = TOL[dtype]
    _close(o.float().numpy(), np.asarray(jo.astype(jnp.float32)), tol, "o")
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
               tol, name)


def test_autograd_path_redraws_the_forwards_bits():
    """The autograd function saves the forward's pair: its gradients
    equal the plain backward fed the pair's mask as ``keep``, and a
    second call draws another pair."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 33, 4, 16).astype(np.float32))
               .requires_grad_() for _ in range(3))
    torch.manual_seed(5)
    o, lse = tfa.flash_attention_fwd(q, k, v, True, dropout_p=0.2)
    do = torch.ones_like(o)
    o.backward(do)
    torch.manual_seed(5)
    pair = prandom.philox_pair("cpu")
    keep = _philox.keep_mask(pair, 1, 4, 33, 33, 0.2)
    ro, _ = tfa._flash_plain(q.detach(), k.detach(), v.detach(), True, None,
                             0.2, keep=keep)
    ref = tfa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), ro, lse,
                               do, True, None, 0.2, keep=keep)
    assert torch.equal(o.detach(), ro)
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(got, want)
    o2 = tfa.flash_attention(q, k, v, True, dropout_p=0.2)
    assert not torch.equal(o2, o)


@pytest.mark.parametrize("p", [-0.1, 1.0, 1.5])
def test_dropout_outside_the_unit_interval_raises(p):
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa.flash_attention(x, x, x, True, dropout_p=p)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa._check_cuda(x, x, x, None, p, torch.zeros(2, dtype=torch.int64))


# ---- GPT and the trainer -------------------------------------------------------
def _pair(**over):
    kw = {**TINY, **over}
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**kw))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm, named


def _batch(seed, b=2, s=64):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _grads(tm, ids, labels):
    tm.train()
    tm.zero_grad(set_to_none=True)
    loss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids).long()),
                                     torch.from_numpy(labels))
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in tm.named_parameters()}


def test_gpt_eval_equals_jax_and_training_draws_fresh_masks():
    jm, tm, _ = _pair(attn_dropout=0.1)
    ids, _ = _batch(1)
    jm.eval()
    tm.eval()
    ref = np.asarray(jm(paddle.to_tensor(ids)).data)
    x = torch.from_numpy(ids).long()
    _close(tm(x).detach().numpy(), ref, 1e-4, "eval logits")
    tm.train()
    pairs = []
    draw = prandom.philox_pair

    def counted(*a, **kw):
        pairs.append(draw(*a, **kw))
        return pairs[-1]

    tfa._random.philox_pair = counted
    try:
        with torch.no_grad():
            first, second = tm(x), tm(x)
    finally:
        tfa._random.philox_pair = draw
    assert len(pairs) == 2 * TINY["num_layers"]
    assert len({tuple(p_.tolist()) for p_ in pairs}) == len(pairs)
    assert not torch.equal(first, second)
    torch.manual_seed(11)
    again = tm(x)
    torch.manual_seed(11)
    assert torch.equal(tm(x), again)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recompute_replays_the_forwards_bits(policy):
    """Under one generator seed, recompute draws the forward's pairs
    again in the backward (``preserve_rng_state``): loss and gradients
    equal the step without recompute, bit for bit."""
    _, tm, _ = _pair(attn_dropout=0.1, dropout=0.1)
    ids, labels = _batch(2)
    torch.manual_seed(3)
    loss0, g0 = _grads(tm, ids, labels)
    tm.enable_recompute(policy)
    torch.manual_seed(3)
    loss1, g1 = _grads(tm, ids, labels)
    assert loss0 == loss1
    for n in g0:
        assert torch.equal(g1[n], g0[n]), n
    torch.manual_seed(4)
    assert _grads(tm, ids, labels)[0] != loss0


def _port_trainer(named, lr=0.0, **strategy):
    tm = GPTForCausalLM(GPTConfig(**TINY, attn_dropout=0.1), device="cpu")
    load_paddle_tpu_params(tm, named)
    st = DistributedStrategy()
    for key, val in strategy.items():
        setattr(st, key, val)
    crit = GPTPretrainingCriterion()
    return SpmdTrainer(tm, topt.SGD(learning_rate=lr),
                       lambda o, lab: crit(o, lab), strategy=st)


def test_reference_trainer_reuses_its_masks_the_port_does_not():
    """The JAX ``SpmdTrainer`` jits its step without ``rng_guard``, so
    ``prandom.next_key()`` splits the global key once, at trace time: at
    learning rate 0 every step repeats the first step's loss, masks
    included.  The port draws fresh pairs each step, so its losses
    differ.  (ROADMAP Queue 3 keeps this as a standing note: the JAX
    trainer is no mask oracle.)"""
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY, attn_dropout=0.1))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    opt = paddle.optimizer.SGD(learning_rate=0.0, parameters=jm.parameters())
    crit = JaxCriterion()
    jtr = JaxTrainer(jm, opt, lambda o, lab: crit(o, lab),
                     mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                     strategy=JaxStrategy())
    ids, labels = _batch(5)
    jl = [float(jtr.train_step(ids, labels)) for _ in range(2)]
    assert jl[0] == jl[1]
    tr = _port_trainer(named)
    tl = [float(tr.train_step(ids, labels)) for _ in range(2)]
    assert tl[0] != tl[1]
    assert abs(tl[0] - jl[0]) < 0.05 * abs(jl[0])


def test_gradient_merge_micro_batches_draw_their_own_bits():
    """Two micro-batches of one merged step draw two pairs a layer, and
    under one generator seed the merged update is reproducible."""
    _, _, named = _pair()
    ids, labels = _batch(6)
    out = []
    for _ in range(2):
        torch.manual_seed(9)
        tr = _port_trainer(named, lr=0.1, gradient_merge=True,
                           gradient_merge_configs={"k_steps": 2})
        losses = [float(tr.train_step(ids, labels)) for _ in range(2)]
        out.append((losses, {n: p.detach().clone()
                             for n, p in tr.model.named_parameters()}))
    (l0, p0), (l1, p1) = out
    assert l0 == l1 and l0[0] != l0[1]
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_rollback_rewinds_the_dropout_bits():
    """A rolled-back step restores the generator with the state: the
    run continues as the run that never saw the bad batch, bit for bit."""
    _, _, named = _pair()
    batches = [_batch(i) for i in (7, 8, 9)]

    def run(bad):
        torch.manual_seed(21)
        tm = GPTForCausalLM(GPTConfig(**TINY, attn_dropout=0.1,
                                      dropout=0.1), device="cpu")
        load_paddle_tpu_params(tm, named)
        crit = GPTPretrainingCriterion()
        poison = {"on": False}

        def loss_fn(o, lab):
            loss = crit(o, lab)
            return loss * float("nan") if poison["on"] else loss

        tr = SpmdTrainer(tm, topt.SGD(learning_rate=0.1), loss_fn,
                         anomaly_policy="rollback")
        losses = []
        for i, b_ in enumerate(batches):
            if i == 1 and not bad:
                continue
            poison["on"] = bad and i == 1
            losses.append(float(tr.train_step(*b_)))
        return ([x for x in losses if np.isfinite(x)],
                {n: p.detach().clone() for n, p in tm.named_parameters()},
                tr.stats["rollback_steps"])

    clean, p_clean, n0 = run(False)
    rolled, p_rolled, n1 = run(True)
    assert (n0, n1) == (0, 1)
    assert rolled == clean
    for n in p_clean:
        assert torch.equal(p_rolled[n], p_clean[n]), n
