"""The port's speculative-decoding engine against its non-speculative
engine and the JAX package's engines, on the CPU.

Greedy speculation only changes the schedule: the streams must equal the
non-speculative engine of the same cache form for K in {1, 2, 4}, dense
and paged, fp and int8, GQA, EOS inside an accepted window, preemption
and resume, and chunked prefill underneath; and the JAX package's
streams on the same converted weights.  The self-draft commits K+1
tokens per tick.  Sampled speculation: the rejection rule's committed
token follows p (total variation against p, acceptance rate against
the overlap of p and q, as tests/test_spec_decode.py holds the JAX
rule), and a seeded engine replays its stream.  One host sync per tick.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.inference.spec_decode import resolve_spec_k
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)


def build_pair(seed=0, **over):
    kw = {**TINY, **over}
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(**kw))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return build_pair()


@pytest.fixture(scope="module")
def draft():
    # a different, one-layer model: it disagrees with the target often
    return build_pair(seed=1, num_layers=1)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 97, (n,)).astype(np.int32) for n in (5, 9, 3)]


def serve(eng, prompts, max_new=12, **kw):
    rids = [eng.add_request(p, max_new_tokens=max_new, **kw)
            for p in prompts]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


def port(tm, **kw):
    return InferenceEngine(tm, batch_slots=2, prefill_buckets=[16],
                           device="cpu", **kw)


def layout_kw(layout):
    return {"kv_layout": layout, **({"kv_block_size": 8}
                                    if layout == "paged" else {})}


@pytest.fixture(scope="module")
def reference(target, prompts):
    """The JAX package's non-speculative dense engine; the port's equals
    it, and every speculative form must too."""
    jm, tm = target
    want = serve(JaxEngine(jm, batch_slots=2, prefill_buckets=[16]), prompts)
    assert serve(port(tm), prompts) == want
    return want


@pytest.mark.parametrize("k,kv_dtype,layout", [
    (1, None, "dense"), (1, "int8", "paged"), (4, None, "paged"),
    (4, "int8", "dense"), (2, None, "dense"), (2, "int8", "paged")])
def test_spec_token_identity_matrix(target, draft, prompts, reference, k,
                                    kv_dtype, layout):
    _, tm = target
    kw = dict(kv_dtype=kv_dtype, **layout_kw(layout))
    want = reference if kv_dtype is None else serve(port(tm, **kw), prompts)
    eng = port(tm, spec_k=k, draft_model=draft[1], **kw)
    assert serve(eng, prompts) == want
    st = eng.stats()
    assert st["spec_k"] == k and st["spec_ticks"] > 0
    assert st["accepted_tokens_per_tick"] >= 1.0
    assert st["decode_host_syncs"] == st["decode_steps"] == st["spec_ticks"]
    if layout == "paged":
        eng.check_leak_free()


def test_spec_tokens_equal_jax_spec_engine(target, draft, prompts,
                                           reference):
    """The JAX speculative engine (run without its compile counter) and
    the port's give the same streams, int8 paged at K = 2."""
    (jm, tm), (jd, td) = target, draft
    kw = dict(spec_k=2, kv_dtype="int8", **layout_kw("paged"))
    got = serve(port(tm, draft_model=td, **kw), prompts)
    assert got == serve(JaxEngine(jm, batch_slots=2, prefill_buckets=[16],
                                  draft_model=jd, **kw), prompts)


def test_spec_token_identity_gqa(prompts):
    jm, tm = build_pair(num_kv_heads=2)
    _, td = build_pair(seed=1, num_kv_heads=2, num_layers=1)
    want = serve(JaxEngine(jm, batch_slots=2, prefill_buckets=[16]), prompts)
    for layout in ("dense", "paged"):
        eng = port(tm, spec_k=2, draft_model=td, **layout_kw(layout))
        assert serve(eng, prompts) == want


def test_spec_eos_mid_window(target, draft):
    """EOS inside an accepted window truncates where the sequential
    rollout stops."""
    _, tm = target
    rng = np.random.RandomState(7)
    hit = 0
    for _ in range(12):
        prompt = rng.randint(1, 97, (rng.randint(3, 9),)).astype(np.int32)
        base = port(tm).generate(prompt, max_new_tokens=10)
        if len(base) < 3:
            continue
        eos = int(base[len(base) // 2])
        want = port(tm).generate(prompt, max_new_tokens=10, eos_id=eos)
        got = port(tm, spec_k=3, draft_model=tm).generate(
            prompt, max_new_tokens=10, eos_id=eos)
        assert got.tolist() == want.tolist() and int(got[-1]) == eos
        hit += 1
        if hit >= 3:
            break
    assert hit >= 1


def test_self_draft_commits_k_plus_one(target, prompts, reference):
    """Drafting with the target accepts every proposal: each tick commits
    K+1 tokens except where max_new_tokens cuts the stream (11 tokens
    after the first over 3 ticks at K = 3: 3.67 a tick)."""
    _, tm = target
    eng = port(tm, spec_k=3, draft_model=tm)
    assert serve(eng, prompts) == reference
    st = eng.stats()
    assert st["accepted_tokens_per_tick"] == pytest.approx(11 / 3)
    assert st["spec_acceptance_rate"] > 0.85
    assert st["spec_capacity_retirements"] == 0


def test_spec_sampled_seeded_determinism(target, draft):
    """Sampled requests ride the spec path; a seeded engine replays its
    stream, and a greedy neighbour still equals the greedy engine."""
    _, tm = target
    prompt = np.array([1, 2, 3], np.int32)

    def run(seed):
        eng = InferenceEngine(tm, batch_slots=2, prefill_buckets=[16],
                              seed=seed, spec_k=2, draft_model=draft[1],
                              device="cpu")
        r_s = eng.add_request(prompt, max_new_tokens=10, temperature=0.8,
                              top_p=0.9)
        r_g = eng.add_request(prompt, max_new_tokens=10)
        out = eng.run()
        return out[r_s].tolist(), out[r_g].tolist()

    s0, g0 = run(7)
    s1, g1 = run(7)
    s2, _ = run(8)
    assert s0 == s1 and g0 == g1
    assert len(s0) == 10 and len(s2) == 10
    assert g0 == port(tm).generate(prompt, max_new_tokens=10).tolist()


def test_spec_sampled_residual_distribution(target, draft):
    """For drafts ~ q, accept with min(1, p/q), else draw from norm(max(p
    - q, 0)): the committed first token's marginal is p (total variation
    under 0.05 at N = 8192; drawing q instead lands near TV(p, q) = 0.46)
    and the acceptance rate is sum(min(p, q))."""
    eng = port(target[1], spec_k=1, draft_model=draft[1])
    sd = eng._spec
    eng._gen.manual_seed(0)
    rng = np.random.RandomState(0)
    v, n = 8, 8192
    p = np.array([.30, .20, .15, .10, .10, .08, .05, .02], np.float32)
    q = p[::-1].copy()
    drafts = torch.from_numpy(rng.choice(v, size=(n, 1), p=q / q.sum()))
    logits = torch.from_numpy(np.broadcast_to(np.log(p), (n, 2, v)).copy())
    ones = torch.ones(n)
    toks, n_acc, n_emit = sd._accept(
        drafts, torch.from_numpy(np.broadcast_to(q, (n, 1, v)).copy()),
        logits, torch.ones(n, dtype=torch.int32), ones, ones)
    assert int(n_emit.min()) >= 1
    h = np.bincount(toks[:, 0].numpy(), minlength=v) / n
    assert 0.5 * float(np.abs(h - p).sum()) < 0.05
    assert abs(float(n_acc.float().mean()) - float(np.minimum(p, q).sum())) \
        < 0.05


def test_spec_draft_validation(target):
    _, tm = target
    _, bad_vocab = build_pair(seed=2, vocab_size=64)
    with pytest.raises(ValueError, match="vocab"):
        port(tm, spec_k=2, draft_model=bad_vocab)
    _, bad_seq = build_pair(seed=2, max_seq_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        port(tm, spec_k=2, draft_model=bad_seq)
    with pytest.raises(ValueError, match="draft_model"):
        port(tm, spec_k=2)
    assert resolve_spec_k(None) == 0 and port(tm, spec_k=0).spec_k == 0


def test_spec_preemption_resume_identity(target, draft):
    """A spec engine over a pool tight enough to preempt still gives the
    non-speculative streams: the resume re-seeds the target blocks and
    the draft cache."""
    _, tm = target
    rng = np.random.RandomState(11)
    ps = [rng.randint(1, 97, (6,)).astype(np.int32) for _ in range(4)]
    want = serve(InferenceEngine(tm, batch_slots=2, prefill_buckets=[8, 16],
                                 device="cpu"), ps, 10)
    eng = InferenceEngine(tm, batch_slots=2, prefill_buckets=[8, 16],
                          kv_layout="paged", kv_block_size=8,
                          kv_num_blocks=5, spec_k=2, draft_model=draft[1],
                          device="cpu")
    assert serve(eng, ps, 10) == want
    assert eng.stats()["preemptions"] >= 1
    eng.check_leak_free()


def test_chunked_with_spec_token_identity(target, draft, prompts,
                                          reference):
    """Prefilling slots sit the spec ticks out, the draft catches up at
    graduation, and the streams equal the non-speculative ones."""
    _, tm = target
    for layout in ("dense", "paged"):
        eng = port(tm, prefill_chunk=4, spec_k=2, draft_model=draft[1],
                   **layout_kw(layout))
        assert serve(eng, prompts) == reference
        st = eng.stats()
        assert st["spec_ticks"] > 0 and st["chunk_ticks"] > 0
        if layout == "paged":
            eng.check_leak_free()


def test_one_host_sync_per_spec_tick(target, draft, prompts, monkeypatch):
    """The catch-up window, tables and lengths reach the device without a
    read back: one read per tick (the [B, K+2] commit) and one per
    admission (its first token)."""
    _, tm = target
    eng = port(tm, spec_k=3, draft_model=draft[1], **layout_kw("paged"))
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    serve(eng, prompts)
    monkeypatch.undo()
    st = eng.stats()
    assert reads["n"] == st["host_syncs"] == st["spec_ticks"] + len(prompts)
