"""Row-sparse embedding gradients (``paddle_tpu_torch.core.selected_rows``,
``Embedding(sparse=True)``, sparse SGD and lazy Adam / AdamW) and
``io.InMemoryDataset`` against the JAX package's on the CPU, and the CTR
pipeline (slot records -> ``Embedding(sparse=True)`` -> lazy Adam) with
the JAX model's weights carried into the port.

Tolerances: merged rows, padding rows and batches equal; dense forms of
sparse gradients within 1e-6 of their scale (f32 sums of a few rows);
parameters after SGD / Adam steps within 1e-5 of their scale (the same
f32 update formulas; Adam divides by sqrt of the second moment, so a
rounding difference in a gradient moves a parameter by at most a few
ulps of the learning rate); the CTR run's per-step losses within 1e-5
and its final table within 1e-4 of their scales (8 steps of such
rounding).
"""
from torch_cpu import unoptimized_jax_compiles  # noqa: F401  (one thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.io import InMemoryDataset as JDataset

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core.selected_rows import SelectedRows, dense_lookups
from paddle_tpu_torch.io import InMemoryDataset

from torch_op_parity import close


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")
    yield


def _np(x):
    return np.asarray(x.data) if isinstance(x, jpaddle.Tensor) else \
        x.detach().cpu().numpy()


def test_merge_and_to_dense_match_jax():
    rows = np.array([3, 1, 3, 0, 1], np.int64)
    vals = np.arange(10, dtype=np.float32).reshape(5, 2)
    sr = SelectedRows(torch.tensor(rows), torch.tensor(vals), (5, 2))
    jsr = JSR(rows.astype(np.int32), jnp.asarray(vals), (5, 2))
    close(sr.numpy(), jsr.numpy(), 0.0, "to_dense")
    m, jm = sr.merge(), jsr.merge()
    assert m.rows.tolist() == np.asarray(jm.rows).tolist() == [0, 1, 3, 5, 5]
    close(_np(m.values), np.asarray(jm.values), 0.0, "merged values")
    close(_np(m.to_dense()), np.asarray(jm.to_dense()), 0.0, "merged dense")
    # merge of a merged form changes nothing
    assert m.merge().rows.tolist() == m.rows.tolist()


def test_add_sparse_and_dense():
    a = SelectedRows(torch.tensor([0, 2]), torch.ones(2, 3), (4, 3))
    b = SelectedRows(torch.tensor([2]), 2 * torch.ones(1, 3), (4, 3))
    both = a + b
    assert isinstance(both, SelectedRows) and both.rows.tolist() == [0, 2, 2]
    expect = np.zeros((4, 3), np.float32)
    expect[0] += 1
    expect[2] += 3
    close(both.numpy(), expect, 0.0)
    densified = a + torch.full((4, 3), 5.0)
    assert torch.is_tensor(densified)
    close(_np(densified), a.numpy() + 5.0, 0.0)
    assert torch.equal(torch.full((4, 3), 5.0) + a, densified)
    with pytest.raises(ValueError, match="mismatch"):
        a + SelectedRows(torch.tensor([0]), torch.ones(1, 3), (5, 3))


def test_sparse_embedding_grad_is_row_sparse():
    tp.seed(0)
    emb = tnn.Embedding(50, 4, sparse=True)
    ids = torch.tensor([[1, 3], [3, 7]])
    emb(ids).sum().backward()
    g = emb.weight.grad
    assert g.is_sparse
    sr = SelectedRows.from_sparse(g)
    assert sorted(sr.rows.tolist()) == [1, 3, 3, 7]
    jemb = jnn.Embedding(50, 4, sparse=True)
    jemb(jpaddle.to_tensor(ids.numpy())).sum().backward()
    close(sr.numpy(), jemb.weight.grad.numpy(), 1e-6, "dense grad")


def test_two_backward_passes_stay_sparse_and_a_dense_use_densifies():
    tp.seed(1)
    emb = tnn.Embedding(20, 3, sparse=True)
    emb(torch.tensor([1, 2])).sum().backward()
    emb(torch.tensor([2, 5, 5])).sum().backward()
    g = emb.weight.grad
    assert g.is_sparse and SelectedRows.from_sparse(g).in_range()[0] \
        .numel() == 5
    expect = np.zeros((20, 3), np.float32)
    for r in (1, 2, 2, 5, 5):
        expect[r] += 1
    close(SelectedRows.from_sparse(g).numpy(), expect, 0.0)
    (emb.weight * 2).sum().backward()
    assert not emb.weight.grad.is_sparse
    close(_np(emb.weight.grad), expect + 2, 0.0)


def test_padding_idx_rows_get_no_gradient():
    tp.seed(0)
    emb = tnn.Embedding(20, 4, padding_idx=0, sparse=True)
    emb(torch.tensor([0, 1, 0, 2])).sum().backward()
    g = SelectedRows.from_sparse(emb.weight.grad).numpy()
    assert (g[0] == 0).all() and (g[1] == 1).all()
    assert (emb(torch.tensor([0])) == 0).all()


def test_minus_one_reads_and_updates_the_last_row():
    """``Embedding(5, 2, sparse=True)`` on ids ``[[1, -1], [2, 1]]``: -1
    reads row 4, merge keeps it, one lazy Adam step at lr 0.1 moves rows
    1, 2 and 4 by -0.1, as in the JAX package."""
    ids = np.array([[1, -1], [2, 1]], np.int64)
    jpaddle.seed(0)
    jemb = jnn.Embedding(5, 2, sparse=True)
    w0 = jemb.weight.numpy().copy()
    emb = tnn.Embedding(5, 2, sparse=True)
    emb.set_state_dict({"weight": torch.tensor(w0)})
    out = emb(torch.tensor(ids))
    close(_np(out), _np(jemb(jpaddle.to_tensor(ids))), 0.0, "lookup")
    assert torch.equal(out[0, 1], emb.weight[4])
    opt = tp.optimizer.Adam(0.1, parameters=emb.parameters(), lazy_mode=True)
    jopt = jpaddle.optimizer.Adam(learning_rate=0.1,
                                  parameters=jemb.parameters(),
                                  lazy_mode=True)
    emb(torch.tensor(ids)).sum().backward()
    jemb(jpaddle.to_tensor(ids)).sum().backward()
    merged = SelectedRows.from_sparse(emb.weight.grad).merge()
    assert merged.rows.tolist() == [1, 2, 4, 5]
    opt.step()
    jopt.step()
    moved = _np(emb.weight) - w0
    close(moved, jemb.weight.numpy() - w0, 1e-5, "lazy step")
    np.testing.assert_allclose(moved[[1, 2, 4]], -0.1, rtol=1e-5)
    assert (moved[[0, 3]] == 0).all()


def _make_opt(mod, name, params, lazy):
    if name == "sgd":
        return mod.optimizer.SGD(learning_rate=0.1, parameters=params)
    if name == "adamw":
        return mod.optimizer.AdamW(learning_rate=0.05, parameters=params,
                                   weight_decay=0.01, lazy_mode=lazy)
    return mod.optimizer.Adam(learning_rate=0.05, parameters=params,
                              lazy_mode=lazy)


@pytest.mark.parametrize("name,lazy", [("sgd", False), ("adam", False),
                                       ("adam", True), ("adamw", True),
                                       ("adamw", False)])
def test_sparse_updates_match_dense_and_jax(name, lazy):
    """Three steps of each rule on the sparse table, its dense twin, and
    the JAX package's sparse table from the same start."""
    ids = np.array([[2, 9, 2], [14, 9, 5]], np.int64)
    tgt = np.random.RandomState(0).randn(2, 3, 8).astype(np.float32)
    jpaddle.seed(7)
    jemb = jnn.Embedding(30, 8, sparse=True)
    w0 = torch.tensor(jemb.weight.numpy())
    emb_s = tnn.Embedding(30, 8, sparse=True)
    emb_d = tnn.Embedding(30, 8)
    for e in (emb_s, emb_d):
        e.set_state_dict({"weight": w0})
    opts = [_make_opt(tp, name, e.parameters(), lazy) for e in (emb_s, emb_d)]
    jopt = _make_opt(jpaddle, name, jemb.parameters(), lazy)
    for _ in range(3):
        for e, o in zip((emb_s, emb_d), opts):
            TF.mse_loss(e(torch.tensor(ids)), torch.tensor(tgt)).backward()
            o.step()
            o.clear_grad()
        JF.mse_loss(jemb(jpaddle.to_tensor(ids)),
                    jpaddle.to_tensor(tgt)).backward()
        jopt.step()
        jopt.clear_grad()
    w_s, w_d, w_j = _np(emb_s.weight), _np(emb_d.weight), jemb.weight.numpy()
    close(w_s, w_j, 1e-5, f"{name} sparse vs JAX")
    touched = [2, 5, 9, 14]
    untouched = [i for i in range(30) if i not in touched]
    close(w_s[touched], w_d[touched], 1e-5, f"{name} touched rows")
    if lazy and name == "adamw":
        # lazy decay: untouched rows stay; the dense rule decays them all
        assert (w_s[untouched] == w0.numpy()[untouched]).all()
        assert not np.allclose(w_d[untouched], w0.numpy()[untouched])
    else:
        close(w_s[untouched], w_d[untouched], 1e-5, f"{name} untouched")


@pytest.mark.parametrize("case", ["lamb", "clip", "coupled-decay"])
def test_unsupported_sparse_updates_raise(case):
    tp.seed(0)
    emb = tnn.Embedding(10, 4, sparse=True)
    if case == "lamb":
        opt = tp.optimizer.Lamb(learning_rate=0.01,
                                parameters=emb.parameters())
        match = "does not support sparse"
    elif case == "clip":
        opt = tp.optimizer.SGD(0.1, parameters=emb.parameters(),
                               grad_clip=tnn.ClipGradByGlobalNorm(1.0))
        match = "grad_clip"
    else:
        opt = tp.optimizer.Adam(0.1, parameters=emb.parameters(),
                                weight_decay=0.01)
        match = "coupled weight decay"
    emb(torch.tensor([1, 2])).sum().backward()
    with pytest.raises(NotImplementedError, match=match):
        opt.step()


def test_trainer_step_looks_up_densely():
    w = torch.nn.Parameter(torch.randn(6, 2))
    with dense_lookups():
        TF.embedding(torch.tensor([1, 4]), w, sparse=True).sum().backward()
    assert not w.grad.is_sparse
    w.grad = None
    TF.embedding(torch.tensor([1, 4]), w, sparse=True).sum().backward()
    assert w.grad.is_sparse


# --------------------------------------------------------------------------
# InMemoryDataset and the CTR pipeline
# --------------------------------------------------------------------------

def _records(n=256, vocab=1000, seed=0):
    """Synthetic CTR records: 1-3 ids a record (ragged, so batches pad
    with -1), ids below vocab - 1 (the row -1 reads), a click drawn from
    a hidden per-id weight."""
    rng = np.random.RandomState(seed)
    hidden = rng.randn(vocab) * 1.5
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab - 1, (rng.randint(1, 4),))
        logit = hidden[ids].sum()
        out.append({"label": [float(rng.rand() < 1 / (1 + np.exp(-logit)))],
                    "slot": ids.tolist(), "dense": rng.rand(2).tolist()})
    return out


def test_in_memory_dataset_matches_jax(tmp_path):
    lines = ["1 slot:3 slot:9 dense:0.5 dense:1.5 other:4",
             "0 2 slot:7 dense:0.25",
             "",
             "1 slot:1 slot:2 slot:3 other:8"]
    path = tmp_path / "part-0"
    path.write_text("\n".join(lines) + "\n")
    kw = dict(use_slots=["slot", "other"], dense_slots={"dense": 2},
              batch_size=2)
    ds, jds = InMemoryDataset(**kw), JDataset(**kw)
    for d in (ds, jds):
        d.load_into_memory([str(path)])
        d.local_shuffle(seed=3)
    assert ds.get_memory_data_size() == jds.get_memory_data_size() == 3
    for a, b in zip(ds.batch_generator(), jds.batch_generator()):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    recs = _records(40)
    for d in (ds, jds):
        d.set_records(recs)
        d.global_shuffle(rank=1, world=2, seed=5)
    assert ds._records == jds._records
    batches = list(ds.batch_generator(batch_size=8, drop_last=True))
    assert all(b["slot"].shape[0] == 8 for b in batches)
    ds.release_memory()
    assert ds.get_memory_data_size() == 0


class _JCTR(jnn.Layer):
    def __init__(self, vocab, dim=8):
        super().__init__()
        self.emb = jnn.Embedding(vocab, dim, sparse=True)
        self.fc = jnn.Linear(dim, 1)

    def forward(self, ids):
        e = self.emb(ids)
        mask = (ids >= 0).astype("float32")
        e = e * mask.unsqueeze(-1)
        pooled = e.sum(axis=1) / jpaddle.clip(
            mask.sum(axis=1, keepdim=True), min=1.0)
        return self.fc(pooled)


class _TCTR(tnn.Layer):
    """The same model from the port's layers and ops."""

    def __init__(self, vocab, dim=8):
        super().__init__()
        self.emb = tnn.Embedding(vocab, dim, sparse=True)
        self.fc = tnn.Linear(dim, 1)

    def forward(self, ids):
        e = self.emb(ids)
        mask = (ids >= 0).astype("float32")
        e = e * mask.unsqueeze(-1)
        pooled = e.sum(axis=1) / tp.clip(mask.sum(axis=1, keepdim=True),
                                         min=1.0)
        return self.fc(pooled)


def test_ctr_pipeline_matches_jax():
    """Slot records -> InMemoryDataset -> Embedding(sparse=True) -> lazy
    Adam, two epochs of 4 batches: the port from the JAX model's
    weights, on the same batches, gives the same losses and tables."""
    vocab = 1000
    recs = _records(256, vocab)
    ds, jds = InMemoryDataset(use_slots=["slot"], batch_size=64), \
        JDataset(use_slots=["slot"], batch_size=64)
    for d in (ds, jds):
        d.set_records(recs)
        d.local_shuffle(seed=0)
    jpaddle.seed(0)
    jmodel = _JCTR(vocab)
    model = _TCTR(vocab)
    model.set_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                          for k, v in jmodel.state_dict().items()})
    jopt = jpaddle.optimizer.Adam(learning_rate=0.05,
                                  parameters=jmodel.parameters(),
                                  lazy_mode=True)
    opt = tp.optimizer.Adam(learning_rate=0.05,
                            parameters=model.parameters(), lazy_mode=True)
    losses, jlosses, padded = [], [], 0
    for _ in range(2):
        for batch, jbatch in zip(ds.batch_generator(),
                                 jds.batch_generator()):
            padded += int((batch["slot"] < 0).sum())
            ids = torch.tensor(batch["slot"])
            labels = torch.tensor(batch["label"][:, :1])
            loss = TF.binary_cross_entropy_with_logits(model(ids), labels)
            loss.backward()
            assert model.emb.weight.grad.is_sparse
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            jl = JF.binary_cross_entropy_with_logits(
                jmodel(jpaddle.to_tensor(jbatch["slot"])),
                jpaddle.to_tensor(jbatch["label"][:, :1]))
            jl.backward()
            jopt.step()
            jopt.clear_grad()
            jlosses.append(float(jl))
    assert padded > 0   # the batches padded ragged slots with -1
    close(np.array(losses), np.array(jlosses), 1e-5, "per-step losses")
    close(_np(model.emb.weight), jmodel.emb.weight.numpy(), 1e-4, "table")
    close(_np(model.fc.weight), jmodel.fc.weight.numpy(), 1e-4, "fc")
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
