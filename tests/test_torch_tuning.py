"""The port's tuning table, compile counter and the table's readers
against the JAX package's on the CPU.

- ``utils.tuning``: a table one package records reads back identically
  in the other (values, provenance, every entry), ``lookup_nearest``
  gives the same answers on a shared table, a corrupt file loads as
  empty in both, and the default path is the port's own;
- ``device_kind``: the card's names normalize to short kinds, the CPU
  reads 'cpu' as JAX's does, and the exec registry shares the function;
- the readers: ``tuned_remat_policy`` and ``default_prefill_buckets``
  agree with JAX's on the same table; ``get_qmm_tiles`` reads the port's
  plan overrides and ignores JAX's TPU block sizes;
- ``utils.compile_counter``: what it counts (new step kinds, captures)
  and ``assert_no_recompiles``.

Every test points ``PADDLE_TPU_TUNING_CACHE`` at a temporary file.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib
import json
import types

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.inference import engine as jengine
from paddle_tpu.utils import tuning as jtuning

from paddle_tpu_torch.distributed import spmd as tspmd
from paddle_tpu_torch.inference import engine as tengine
from paddle_tpu_torch.observability import exec_registry as tregistry
from paddle_tpu_torch.utils import compile_counter as tcc
from paddle_tpu_torch.utils import tuning as ttuning

tqmm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    monkeypatch.setenv("PADDLE_TPU_TUNING_CACHE", str(path))
    monkeypatch.delenv("PADDLE_TPU_PREFILL_BUCKETS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_TUNING", raising=False)
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()
    yield path
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()


def _fresh():
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()


RECORDS = [
    ("prefill_buckets", ("cpu", 64), [16, 64], dict(source="autotune",
                                                    run="live-1",
                                                    improvement=0.125)),
    ("remat_policy", ("cpu", 2048, 24, 2048), "dots",
     dict(source="autotune", run="r1", improvement=0.05)),
    ("qmm_tiles", ("h100", 512, 2048, 8192, "int8"),
     {"bn": 256, "splits": 2}, dict(source="sweep")),
    ("flag", ("cpu", True, 3), 7, {}),
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_table_written_by_one_package_reads_in_the_other(table, writer):
    w, r = (jtuning, ttuning) if writer == "jax" else (ttuning, jtuning)
    for op, key, val, prov in RECORDS:
        w.record(op, key, val, **prov)
    _fresh()
    for op, key, val, prov in RECORDS:
        assert r.lookup(op, key) == val
        assert r.provenance(op, key) == w.provenance(op, key)
        if prov:
            assert r.provenance(op, key)["source"] == prov["source"]
    assert r.all_entries() == w.all_entries()
    # the disk format is one flat JSON object in both
    data = json.loads(table.read_text())
    assert "flag|cpu|1|3" in data and \
        "__meta__|prefill_buckets|cpu|64" in data


def test_lookup_nearest_agrees_on_a_shared_table(table):
    for m, n, k, v in ((64, 2048, 2048, "a"), (512, 2048, 8192, "b"),
                       (4096, 8192, 2048, "c"), (512, 6144, 2048, "d")):
        jtuning.record("qmm_tiles", ("h100", m, n, k, "int8"), v)
    jtuning.record("qmm_tiles", ("h100", "x", 1, 1, "int8"), "bad")
    jtuning.record("qmm_tiles", ("v5e", 512, 2048, 2048, "int8"), "tpu")
    _fresh()
    rng = np.random.RandomState(0)
    for _ in range(40):
        q = ("h100", int(2 ** rng.randint(4, 14)),
             int(rng.choice([1024, 2048, 6144, 8192])),
             int(rng.choice([2048, 8192])), rng.choice(["int8", "fp8"]))
        for max_dist in (None, 1.0):
            got = ttuning.lookup_nearest("qmm_tiles", q, (0, 4), (1, 2, 3),
                                         max_dist=max_dist)
            want = jtuning.lookup_nearest("qmm_tiles", q, (0, 4),
                                          (1, 2, 3), max_dist=max_dist)
            assert got == want, q


def test_corrupt_table_loads_empty_and_is_rewritten(table):
    table.write_text("{not json")
    _fresh()
    assert ttuning.lookup("x", ("a",)) is None
    assert jtuning.lookup("x", ("a",)) is None
    ttuning.record("x", ("a",), 1)
    assert json.loads(table.read_text()) == {"x|a": 1}


def test_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_TUNING_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert ttuning.tuning_path() == str(
        tmp_path / "paddle_tpu_torch" / "tuning.json")
    assert jtuning.tuning_path() == str(
        tmp_path / "paddle_tpu" / "tuning.json")
    for off in ("0", "off"):
        monkeypatch.setenv("PADDLE_TPU_TUNING_CACHE", off)
        assert ttuning.tuning_path() is None


def test_device_kind_normalizes_and_is_shared():
    for name, kind in (("NVIDIA H100 80GB HBM3", "h100"),
                       ("NVIDIA H100 PCIe", "h100"),
                       ("NVIDIA A100-SXM4-40GB", "a100"),
                       ("TPU v5 lite", "v5e"), ("TPU v4", "v4")):
        assert ttuning.normalize_kind(name) == kind
    assert ttuning.normalize_kind("TPU v5 lite") == \
        jtuning.normalize_kind("TPU v5 lite")
    # no card: the JAX package's CPU kind, and the registry reports none
    assert ttuning.device_kind() == jtuning.device_kind() == "cpu"
    assert tregistry.device_kind() == ""
    assert tregistry.peak_flops("h100") == (989e12, False)


def _model(hidden, layers, seq):
    return types.SimpleNamespace(cfg=types.SimpleNamespace(
        hidden_size=hidden, num_layers=layers, max_seq_len=seq))


def test_tuned_remat_policy_agrees_with_jax(table):
    jtuning.record("remat_policy", ("cpu", 2048, 24, 2048), "dots")
    jtuning.record("remat_policy", ("cpu", 768, 12, 2048), "off")
    jtuning.record("remat_policy", ("v5e", 4096, 32, 2048), "full")
    _fresh()
    for shape in ((2048, 24, 2048), (2048, 16, 2048), (2048, 4, 2048),
                  (768, 12, 2048), (1024, 24, 2048), (4096, 32, 2048),
                  (64, 2, 64)):
        m = _model(*shape)
        assert tspmd.tuned_remat_policy(m) == jspmd.tuned_remat_policy(m)
        assert tspmd.remat_policy_key(m.cfg) == jspmd.remat_policy_key(m.cfg)
    assert tspmd.tuned_remat_policy(_model(2048, 24, 2048)) == "dots"
    assert tspmd.tuned_remat_policy(types.SimpleNamespace()) is None


def test_default_prefill_buckets_agrees_with_jax(table, monkeypatch):
    for n in (64, 100, 2048):
        assert tengine.default_prefill_buckets(n) == \
            jengine.default_prefill_buckets(n)
    jtuning.record("prefill_buckets", ("cpu", 2048), [128, 512, 2048])
    _fresh()
    for n in (64, 2048):
        assert tengine.default_prefill_buckets(n) == \
            jengine.default_prefill_buckets(n)
    assert tengine.default_prefill_buckets(2048) == [128, 512, 2048]
    monkeypatch.setenv("PADDLE_TPU_PREFILL_BUCKETS", "32,64,4096")
    assert tengine.default_prefill_buckets(2048) == \
        jengine.default_prefill_buckets(2048) == [32, 64]


def test_get_qmm_tiles_reads_plan_overrides(table, monkeypatch):
    monkeypatch.setattr(ttuning, "device_kind", lambda: "h100")
    assert tqmm.get_qmm_tiles(512, 2048, 8192) is None
    ttuning.record("qmm_tiles", ("h100", 512, 2048, 8192, "int8"),
                   {"bn": 256, "splits": 2}, source="sweep")
    # M bucketed to its power of two; at or below M = 16 no plan
    assert tqmm.get_qmm_tiles(700, 2048, 8192) == {"bn": 256, "splits": 2}
    assert tqmm.get_qmm_tiles(16, 2048, 8192) is None
    # nearest tabled shape; splits clamped to K / 128, bn 256 only where
    # it divides N
    assert tqmm.get_qmm_tiles(256, 2048, 8192) == {"bn": 256, "splits": 2}
    ttuning.record("qmm_tiles", ("h100", 64, 384, 256, "int8"),
                   {"bn": 256, "splits": 8})
    assert tqmm.get_qmm_tiles(64, 384, 256) is None
    ttuning.record("qmm_tiles", ("h100", 64, 512, 256, "int8"),
                   {"bn": 128, "splits": 8})
    assert tqmm.get_qmm_tiles(64, 512, 256) == {"bn": 128, "splits": 2}
    # the JAX package's TPU block sizes are not plans of this kernel
    ttuning.record("qmm_tiles", ("h100", 1024, 4096, 4096, "int8"),
                   [256, 256, 512])
    assert tqmm.get_qmm_tiles(1024, 4096, 4096) is None
    with pytest.raises(ValueError, match="decode regime"):
        tqmm.autotune_qmm_sweep(8, 2048, 2048)


def test_compile_counter_counts_step_kinds_and_captures(table):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.inference import InferenceEngine
    m = GPTForCausalLM(GPTConfig(vocab_size=97, hidden_size=32,
                                 num_layers=1, num_heads=2, max_seq_len=32),
                       device="cpu")
    eng = InferenceEngine(m, device="cpu", batch_slots=2,
                          prefill_buckets=[8, 16])
    snap = tcc.snapshot()
    eng.generate(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    # the first prefill at bucket 8, the sampler, the decode step
    assert snap.by_kind()["step_kind"] == 3
    with tcc.assert_no_recompiles("warm loop"):
        eng.generate(np.arange(2, 7, dtype=np.int32), max_new_tokens=3)
    with pytest.raises(AssertionError, match="1 compile"):
        with tcc.assert_no_recompiles("new bucket"):
            eng.generate(np.arange(1, 12, dtype=np.int32),
                         max_new_tokens=1)
    paddle.set_device("cpu")
    lin = paddle.jit.to_static(paddle.nn.Linear(4, 3))
    snap = tcc.snapshot()
    lin(torch.ones(2, 4))
    lin(torch.ones(2, 4))
    assert snap.new_traces == 1 and snap.new_compiles == 1
    with pytest.raises(ValueError):
        tcc.note("xla")
    counts = tcc.compile_counts()
    assert counts["compiles"] == sum(counts[k] for k in tcc.KINDS)
