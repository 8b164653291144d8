"""``hapi.Model``, ``io`` and ``metric`` of the port against the JAX
package's, on the CPU.

``Model.fit`` with SGD over 2 epochs x 3 batches (``shuffle=False``)
import torch_cpu  # noqa: F401  (one intra-op thread)
from the same weights: per-step losses, final parameters, ``Accuracy``,
``evaluate`` and ``predict`` equal to the JAX package's eager
``Model.fit``; ``ModelCheckpoint`` files load into the JAX network;
``save`` / ``load`` into a fresh ``Model`` keep the evaluation loss;
``auto_resume`` continues after the last saved epoch; a small
Transformer trains through ``fit`` under ``auto_cast`` and through
``prepare(strategy=...)`` (the trainer loop); the samplers, the
DataLoader and the metrics against the JAX ones.

Tolerances (f32): losses, parameters and outputs within 1e-5 relative
(RTOL) and 1e-6 absolute (ATOL).  Worst measured: 3.6e-7 absolute, 0.06
of the tolerance.  Metrics over the same predictions are equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import callbacks as jcb

import paddle_tpu_torch as tp
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.hapi import callbacks as tcb

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU.  The JAX reference runs op by op on its tape
    and compiles each op once per shape: these compiles skip XLA's
    optimization passes and the persistent cache (none is reused)."""
    import jax
    tp.set_device("cpu")
    tp.seed(17)
    keys = ("jax_disable_most_optimizations", "jax_enable_compilation_cache")
    was = {k: jax.config.values[k] for k in keys}
    jax.config.update("jax_disable_most_optimizations", True)
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    for k, v in was.items():
        jax.config.update(k, v)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t.data)


def _data(n=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    y = rng.randint(0, 4, (n, 1)).astype(np.int64)
    return x, y


def _net(nn):
    return nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 4))


class _Losses:
    """A callback class (per package) recording each train step's
    loss."""

    @staticmethod
    def make(cb_mod):
        class Rec(cb_mod.Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs["loss"]))
        return Rec()


def _fit_pair(tmp_path=None, epochs=2):
    x, y = _data()
    jnet, tnet = _net(jnn), _net(tnn)
    tnet.set_state_dict({k: _np(v) for k, v in jnet.state_dict().items()})
    jm = jp.Model(jnet)
    jm.prepare(jp.optimizer.SGD(learning_rate=0.1,
                                parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), jmetric.Accuracy(topk=(1, 2)))
    tm = tp.Model(tnet)
    tm.prepare(tp.optimizer.SGD(learning_rate=0.1,
                                parameters=tnet.parameters()),
               tnn.CrossEntropyLoss(), tmetric.Accuracy(topk=(1, 2)))
    jrec, trec = _Losses.make(jcb), _Losses.make(tcb)
    jm.fit(jio.TensorDataset([x, y]), batch_size=4, epochs=epochs,
           shuffle=False, verbose=0, callbacks=[jrec])
    tm.fit(tio.TensorDataset([x, y]), batch_size=4, epochs=epochs,
           shuffle=False, verbose=0, callbacks=[trec],
           save_dir=None if tmp_path is None else str(tmp_path))
    return jm, tm, jrec.losses, trec.losses


def test_fit_evaluate_predict_match_jax(tmp_path):
    jm, tm, jl, tl = _fit_pair(tmp_path)
    assert len(tl) == 6
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for k, v in jm.network.state_dict().items():
        np.testing.assert_allclose(_np(tm.network.state_dict()[k]), _np(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    x, y = _data(8, seed=1)
    jev = jm.evaluate(jio.TensorDataset([x, y]), batch_size=4, verbose=0)
    tev = tm.evaluate(tio.TensorDataset([x, y]), batch_size=4, verbose=0)
    assert sorted(tev) == sorted(jev) == ["acc_top1", "acc_top2", "loss"]
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k], rtol=RTOL, atol=ATOL)
    jpred = jm.predict(jio.TensorDataset([x]), batch_size=4,
                       stack_outputs=True)
    tpred = tm.predict(tio.TensorDataset([x]), batch_size=4,
                       stack_outputs=True)
    np.testing.assert_allclose(tpred[0], jpred[0], rtol=RTOL, atol=ATOL)
    assert isinstance(tpred[0], np.ndarray) and tpred[0].shape == (8, 4)
    # ModelCheckpoint's files (save_dir) load into the JAX network
    for tag in ("0", "final"):
        jnet = _net(jnn)
        jnet.set_state_dict(jp.load(str(tmp_path / f"{tag}.pdparams")))
        if tag == "final":
            for k, v in tm.network.state_dict().items():
                np.testing.assert_array_equal(_np(jnet.state_dict()[k]),
                                              _np(v))
    assert (tmp_path / "final.pdopt").exists()


def test_save_and_load_into_a_fresh_model(tmp_path):
    _, tm, _, _ = _fit_pair(epochs=1)
    x, y = _data(8, seed=2)
    ds = tio.TensorDataset([x, y])
    before = tm.evaluate(ds, batch_size=8, verbose=0)
    tm.save(str(tmp_path / "ck"))
    fresh = tp.Model(_net(tnn))
    fresh.prepare(tp.optimizer.SGD(learning_rate=0.1,
                                   parameters=fresh.parameters()),
                  tnn.CrossEntropyLoss(), tmetric.Accuracy(topk=(1, 2)))
    fresh.load(str(tmp_path / "ck"))
    after = fresh.evaluate(ds, batch_size=8, verbose=0)
    assert after == before
    # a checkpoint of another network: names missing -> raises, unless
    # skip_mismatch
    other = tp.Model(tnn.Sequential(tnn.Linear(6, 4)))
    with pytest.raises(ValueError):
        other.load(str(tmp_path / "ck"))
    other.load(str(tmp_path / "ck"), skip_mismatch=True)


def test_auto_resume_continues_after_the_saved_epoch(tmp_path):
    x, y = _data()
    ds = tio.TensorDataset([x, y])

    def run(epochs):
        tp.seed(3)
        m = tp.Model(_net(tnn))
        m.prepare(tp.optimizer.SGD(learning_rate=0.1,
                                   parameters=m.parameters()),
                  tnn.CrossEntropyLoss())
        rec = _Losses.make(tcb)
        m.fit(ds, batch_size=4, epochs=epochs, shuffle=False, verbose=0,
              callbacks=[rec], save_dir=str(tmp_path), auto_resume=True)
        return m, rec.losses

    _, first = run(1)
    m, second = run(3)
    assert len(first) == 3 and len(second) == 6
    straight, _ = _fit_three(ds)
    for k, v in straight.network.state_dict().items():
        np.testing.assert_allclose(_np(m.network.state_dict()[k]), _np(v),
                                   rtol=RTOL, atol=ATOL)


def _fit_three(ds):
    tp.seed(3)
    m = tp.Model(_net(tnn))
    m.prepare(tp.optimizer.SGD(learning_rate=0.1, parameters=m.parameters()),
              tnn.CrossEntropyLoss())
    rec = _Losses.make(tcb)
    m.fit(ds, batch_size=4, epochs=3, shuffle=False, verbose=0,
          callbacks=[rec])
    return m, rec.losses


class _Seq2Seq(tnn.Layer):
    """A small encoder-decoder over shared embeddings (the chip's
    Transformer-base path at d_model 32)."""

    def __init__(self, vocab=16, d=32):
        super().__init__()
        self.emb = tnn.Embedding(vocab, d)
        self.tr = tnn.Transformer(d, 4, 1, 1, 64, dropout=0.1)
        self.out = tnn.Linear(d, vocab)
        self.d = d

    def forward(self, src, tgt):
        mask = self.tr.generate_square_subsequent_mask(tgt.shape[1])
        h = self.tr(self.emb(src) * self.d ** 0.5,
                    self.emb(tgt) * self.d ** 0.5, tgt_mask=mask)
        return self.out(h)


class _SmoothedCE(tnn.Layer):
    def forward(self, logits, label):
        soft = tnn.functional.label_smooth(
            tnn.functional.one_hot(label, logits.shape[-1]), epsilon=0.1)
        return tnn.functional.cross_entropy(logits, soft, soft_label=True)


@pytest.mark.parametrize("loop", ["eager-auto_cast", "trainer"])
def test_transformer_trains_through_fit(loop):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.nn.functional import attention
    rng = np.random.RandomState(5)
    src = rng.randint(1, 16, (8, 8)).astype(np.int64)
    ds = tio.TensorDataset([src, src, src])
    tp.seed(9)
    net = _Seq2Seq()
    m = tp.Model(net)
    opt = tp.optimizer.Adam(learning_rate=3e-3, parameters=m.parameters())
    before = attention.COMPOSITE.launches
    rec = _Losses.make(tcb)
    if loop == "trainer":
        strategy = DistributedStrategy()
        strategy.amp = True
        m.prepare(opt, _SmoothedCE(), tmetric.Accuracy(), strategy=strategy)
        m.fit(ds, batch_size=4, epochs=3, shuffle=False, verbose=0,
              callbacks=[rec])
        assert m._trainer is not None and m._trainer.amp_enabled
    else:
        m.prepare(opt, _SmoothedCE(), tmetric.Accuracy())
        with tp.amp.auto_cast(dtype="bfloat16"):
            m.fit(ds, batch_size=4, epochs=3, shuffle=False, verbose=0,
                  callbacks=[rec])
    assert len(rec.losses) == 6 and np.all(np.isfinite(rec.losses))
    assert np.mean(rec.losses[-2:]) < np.mean(rec.losses[:2])
    ev = m.evaluate(ds, batch_size=4, verbose=0)
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["acc"] <= 1.0
    out = m.predict(tio.TensorDataset([src, src]), batch_size=4)
    assert out[0][0].shape == (4, 8, 16)
    # the CPU runs the plain attention; the composite counter counts
    # CUDA calls only
    assert attention.COMPOSITE.launches == before


def test_samplers_and_dataloader_match_jax():
    x = np.arange(20, dtype=np.float64).reshape(10, 2)
    y = np.arange(10, dtype=np.int64)
    jl = jio.DataLoader(jio.TensorDataset([x, y]), batch_size=4,
                        drop_last=False)
    tl = tio.DataLoader(tio.TensorDataset([x, y]), batch_size=4,
                        drop_last=False)
    assert len(tl) == len(jl) == 3
    for jb, tb in zip(jl, tl):
        assert tb[0].dtype == torch.float32
        np.testing.assert_array_equal(tb[0].numpy(), _np(jb[0]))
        np.testing.assert_array_equal(tb[1].numpy(), _np(jb[1]))
    for cls in ("SequenceSampler",):
        assert list(getattr(tio, cls)(list(range(5)))) == \
            list(getattr(jio, cls)(list(range(5))))
    jb = jio.BatchSampler(list(range(7)), batch_size=3, drop_last=True)
    tb = tio.BatchSampler(list(range(7)), batch_size=3, drop_last=True)
    assert list(tb) == list(jb) and len(tb) == len(jb)
    jd = jio.DistributedBatchSampler(list(range(9)), 2, num_replicas=2,
                                     rank=1, shuffle=True)
    td = tio.DistributedBatchSampler(list(range(9)), 2, num_replicas=2,
                                     rank=1, shuffle=True)
    jd.set_epoch(3)
    td.set_epoch(3)
    assert list(td) == list(jd)
    np.random.seed(4)
    a = list(tio.RandomSampler(list(range(8))))
    np.random.seed(4)
    assert a == list(jio.RandomSampler(list(range(8))))
    dicts = [{"a": np.ones(2), "b": 3} for _ in range(3)]
    batch = tio.default_collate_fn(dicts)
    assert batch["a"].shape == (3, 2) and list(batch["b"]) == [3, 3, 3]
    cat = tio.ConcatDataset([tio.TensorDataset([x]),
                             tio.TensorDataset([y])])
    assert len(cat) == 20 and cat[12][0] == 2


def test_metrics_match_jax():
    rng = np.random.RandomState(6)
    pred = rng.rand(20, 5).astype(np.float32)
    lab = rng.randint(0, 5, (20, 1)).astype(np.int64)
    ja, ta = jmetric.Accuracy(topk=(1, 3)), tmetric.Accuracy(topk=(1, 3))
    ja.update(ja.compute(jp.to_tensor(pred), jp.to_tensor(lab)))
    ta.update(ta.compute(torch.from_numpy(pred), torch.from_numpy(lab)))
    assert ta.accumulate() == pytest.approx(ja.accumulate())
    assert ta.name() == ja.name()
    p1 = rng.rand(30).astype(np.float32)
    l1 = rng.randint(0, 2, 30)
    for name in ("Precision", "Recall", "Auc"):
        jmt, tmt = getattr(jmetric, name)(), getattr(tmetric, name)()
        jmt.update(p1, l1)
        tmt.update(torch.from_numpy(p1), torch.from_numpy(l1))
        assert tmt.accumulate() == pytest.approx(ja_val := jmt.accumulate()), \
            (name, ja_val)
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(lab),
                           k=2)
    want = jmetric.accuracy(jp.to_tensor(pred), jp.to_tensor(lab), k=2)
    assert float(got) == pytest.approx(float(want))
    seg_p = rng.randint(0, 3, (4, 4))
    seg_l = rng.randint(0, 3, (4, 4))
    tm_, tw, tc = tmetric.mean_iou(seg_p, seg_l, 3)
    jm_, jw, jc = jmetric.mean_iou(seg_p, seg_l, 3)
    assert tm_ == pytest.approx(jm_)
    assert np.array_equal(tw, jw) and np.array_equal(tc, jc)


def test_callbacks_early_stopping_and_lr_schedule():
    x, y = _data()
    ds = tio.TensorDataset([x, y])
    tp.seed(2)
    m = tp.Model(_net(tnn))
    sched = tp.optimizer.lr.NoamDecay(d_model=8, warmup_steps=4)
    m.prepare(tp.optimizer.Adam(learning_rate=sched,
                                parameters=m.parameters()),
              tnn.CrossEntropyLoss())
    hist = tcb.History()
    m.fit(ds, batch_size=4, epochs=2, shuffle=False, verbose=0,
          callbacks=[hist])
    # LRScheduler (added by default) steps the schedule once a batch
    assert sched.last_epoch == 6
    assert len(hist.history["loss"]) == 2
    stop = tcb.EarlyStopping(monitor="loss", patience=0, verbose=0,
                             min_delta=1e9)
    m.fit(ds, batch_size=4, epochs=5, shuffle=False, verbose=0,
          callbacks=[stop])
    assert m.stop_training and stop.wait == 1
