"""The port's report CLI against the JAX package's on the CPU.

For the same snapshot, bundle, rows and tuning-table JSON, the rendered
tables are the JAX report's text for text, apart from the program name
in the banner lines; the exit codes are the same (0 rendered something,
2 nothing to render).  The snapshot comes from a tiny CPU engine whose
step kinds were analyzed, so the executables table carries flops, bytes
and roofline columns.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.observability import report as jreport
from paddle_tpu.utils import tuning as jtuning

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import exec_registry as tregistry
from paddle_tpu_torch.observability import flightrec as tflightrec
from paddle_tpu_torch.observability import report as treport
from paddle_tpu_torch.utils import tuning as ttuning


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("PADDLE_TPU_FLIGHTREC_DIR", str(tmp_path / "fr"))
    monkeypatch.delenv("PADDLE_TPU_METRICS", raising=False)
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()
    cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=64)
    model = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=prandom.seed(5, "cpu"))
    eng = InferenceEngine(model, device="cpu", batch_slots=2,
                          prefill_buckets=[8, 16])
    eng.generate(np.arange(1, 9, dtype=np.int32), max_new_tokens=10)
    tregistry.analyze_all(eng._exec_component)
    snap = tmp_path / "snap.jsonl"
    tobs.write_snapshot(str(snap))
    ttuning.record("prefill_buckets", ("h100", 2048), [128, 2048],
                   source="autotune", run="live-1", improvement=0.0625)
    ttuning.record("remat_policy", ("h100", 2048, 24, 2048), "dots",
                   source="autotune", run="gpt3-1.3b", improvement=0.031)
    ttuning.record("qmm_tiles", ("h100", 512, 2048, 8192, "int8"),
                   {"bn": 256, "splits": 2}, source="sweep")
    bundle = tflightrec.dump("autotune-rollback",
                             extra={"autotune": {"reason": "regression"}})
    rows = tmp_path / "rows.jsonl"
    rows.write_text(json.dumps({"doctor": eng.stats()["doctor"] or [
        {"bottleneck": "host-sync-bound", "score": 0.5,
         "evidence": {"syncs_per_step": 1.0}, "knob": "x",
         "action": {"op": None, "param": None, "env": None,
                    "candidates": []}}]}) + "\n")
    yield {"snapshot": str(snap), "bundle": bundle, "rows": str(rows),
           "component": eng._exec_component}
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()


def _run(mod, argv, capsys):
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()
    rc = mod.main(argv)
    out = capsys.readouterr().out
    return rc, out.replace("paddle_tpu_torch", "<prog>").replace(
        "paddle_tpu", "<prog>")


@pytest.mark.parametrize("argv", [
    ["--snapshot", "{snapshot}"], ["--bundle", "{bundle}"],
    ["--rows", "{rows}"], ["--tuning"],
    ["--tuning", "--snapshot", "{snapshot}", "--rows", "{rows}"]])
def test_rendered_tables_equal_jax(files, capsys, argv):
    argv = [a.format(**files) for a in argv]
    got = _run(treport, argv, capsys)
    want = _run(jreport, argv, capsys)
    assert got == want
    assert got[0] == 0 and got[1]


def test_snapshot_carries_the_cost_model_columns(files, capsys):
    rec = treport.load_snapshot_file(files["snapshot"])
    rows = [r for r in rec["executables"]["executables"]
            if r["component"] == files["component"]]
    assert rows and all(r["analyzed"] and r["bytes_accessed"] for r in rows)
    text = treport.render_executables(rec["executables"])
    assert text == jreport.render_executables(rec["executables"])
    assert "bandwidth" in text or "compute" in text
    assert treport.render_tuning().count("autotune") == 2


def test_exit_codes_match_jax(files, tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    os.environ["PADDLE_TPU_FLIGHTREC_DIR"] = str(empty)
    for argv in (["--snapshot", str(tmp_path / "none.jsonl")],
                 ["--bundle", str(empty)], []):
        assert treport.main(argv) == jreport.main(argv) == 2
    capsys.readouterr()
