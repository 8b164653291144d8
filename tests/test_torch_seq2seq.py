"""The attention seq2seq of ``chip_smoke.py`` (PaddleNLP's
``seq2seq_attn.py``: LSTM encoder, input-feeding decoder cell over a
stack of ``LSTMCell``s with Luong attention) built in both packages from
the same weights, on the CPU at small widths (vocabularies 23 and 19,
hidden 16, 2 layers, 6 tokens a side, dropout 0).

- The masked loss and every parameter's gradient: the JAX tape staged
  under one ``jax.jit``; the loss within ``TOL_LOSS`` (relative) and each
  gradient within ``TOL_GRAD`` of its max |value| (f32 on both sides;
  the order of f32 sums differs).
- ``nn.BeamSearchDecoder`` / ``nn.dynamic_decode`` over the cell at beam
  3 (the cell's state a tuple tree of ``[B * K, H]`` leaves, the memory
  tiled by ``tile_beam_merge_with_batch``): ids equal to the JAX search's,
  scores within ``TOL_SCORE`` of |score| (as ``tests/test_parity_round5.py``
  drives the JAX decoder over a ``GRUCell``).
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp

import paddle_tpu_torch as tp

cs = importlib.import_module("chip_smoke")

SRC_V, TRG_V, H, L, B, T = 23, 19, 16, 2, 3, 6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_SCORE = 1e-5


def _data():
    rng = np.random.RandomState(4)
    src = rng.randint(2, SRC_V, (B, T)).astype(np.int64)
    src[0, -2:] = cs.S2S_EOS          # padding, masked in the attention
    trg = rng.randint(2, TRG_V, (B, T)).astype(np.int64)
    trg[:, 0] = cs.S2S_BOS
    lab = np.roll(trg, -1, axis=1)
    lab[:, -1] = cs.S2S_EOS
    lab[1, 2] = cs.S2S_EOS            # later targets masked out
    return src, trg, lab


def _build(paddle):
    return cs.seq2seq_model(paddle, SRC_V, TRG_V, H, L, dropout=0.0)


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the port's twin with its weights."""
    jp.seed(5)
    jmodel, jcrit = _build(jp)
    state = {n: np.asarray(v.data) for n, v in jmodel.state_dict().items()}
    tp.set_device("cpu")
    tp.seed(5)
    tmodel, tcrit = _build(tp)
    assert list(tmodel.state_dict()) == list(state)
    tmodel.set_state_dict(state)
    return jmodel, jcrit, state, tmodel, tcrit


def test_loss_and_gradients_match_jax(pair):
    jmodel, jcrit, state, tmodel, tcrit = pair
    src, trg, lab = _data()

    def loss_grads(st):
        jmodel.set_state_dict({n: jp.Tensor(v) for n, v in st.items()})
        loss = jcrit(jmodel(jp.to_tensor(src), jp.to_tensor(trg)),
                     jp.to_tensor(lab))
        loss.backward()
        return loss.data, {n: p.grad.data
                           for n, p in jmodel.named_parameters()}

    jloss, jgrads = jax.jit(loss_grads)(state)
    # the trace left its values in the layer
    jmodel.clear_gradients()
    jmodel.set_state_dict({n: jp.Tensor(v) for n, v in state.items()})
    tmodel.train()
    loss = tcrit(tmodel(torch.from_numpy(src), torch.from_numpy(trg)),
                 torch.from_numpy(lab))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL_LOSS)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(jgrads)
    for n, g in jgrads.items():
        g = np.asarray(g)
        err = np.abs(got[n].grad.numpy() - g).max() / max(
            np.abs(g).max(), 1e-6)
        assert err <= TOL_GRAD, f"{n}: {err:.3e}"
    tmodel.clear_gradients()


def test_beam_search_matches_jax(pair):
    jmodel, _, state, tmodel, _ = pair
    jmodel.set_state_dict({n: jp.Tensor(v) for n, v in state.items()})
    src, _, _ = _data()
    K, steps = 3, 7
    tmodel.eval()
    jmodel.eval()
    with torch.no_grad():
        tids, tscores = tmodel.beam_search(torch.from_numpy(src), K, steps)
    # the JAX search traces the cell in a lax.scan on raw arrays: wrap
    # them as Tensors for the layers
    Tensor = jp.Tensor
    enc_out, state = jmodel.encoder(jp.to_tensor(src))
    init = jmodel.initial_states(enc_out, state)
    tile = jp.nn.BeamSearchDecoder.tile_beam_merge_with_batch
    cell = jmodel.decoder.lstm_attention.cell
    cell.memory = (tile(enc_out, K),
                   tile(jmodel.padding_mask(jp.to_tensor(src)), K))

    def jcell(x, states):
        wrapped = jax.tree_util.tree_map(Tensor, states)
        return cell(Tensor(x), wrapped)

    dec = jp.nn.BeamSearchDecoder(
        jcell, cs.S2S_BOS, cs.S2S_EOS, K,
        embedding_fn=lambda t: jmodel.decoder.embedder(Tensor(t)),
        output_fn=lambda o: jmodel.decoder.output_layer(Tensor(o)))
    jids, jscores = jp.nn.dynamic_decode(dec, inits=init,
                                         max_step_num=steps)
    jids = np.asarray(jids.data)
    jscores = np.asarray(getattr(jscores, "data", jscores))
    assert tuple(tids.shape) == jids.shape == (B, steps, K)
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tscores.numpy(), jscores, rtol=TOL_SCORE,
                               atol=0)
