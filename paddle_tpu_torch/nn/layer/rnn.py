"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``): the
cells ``SimpleRNNCell`` / ``LSTMCell`` / ``GRUCell``, ``RNN`` and ``BiRNN``
over a cell, and the multi-layer ``SimpleRNN`` / ``LSTM`` / ``GRU``.

The JAX package runs its time loops as ``lax.scan`` outside Pallas; the
port runs them on ATen's RNN ops, which are cuDNN on the card and ATen's
own loop on the CPU:
- ``_RNNBase.forward`` makes one ``torch._VF.lstm`` / ``gru`` /
  ``rnn_tanh`` / ``rnn_relu`` call per layer, both directions in that
  call.  On the card a layer's parameters are moved once into one
  buffer in cuDNN's own layout (``_RNNBase._flatten``), so cuDNN reads
  them in place; weights cast by ``auto_cast`` are moved on every call.
  The dropout between layers is ``F.dropout`` (training only, between layers
  only, as in JAX), never cuDNN's internal dropout;
- the cells are ``torch.lstm_cell`` / ``gru_cell`` / ``rnn_tanh_cell`` /
  ``rnn_relu_cell``, whose formulas are the JAX step bodies: gates in the
  order i, f, g, o (LSTM) and r, z, n (GRU), GRU's ``n`` taking
  ``r * (W_hn h + b_hn)``.

As in the JAX package: ``sequence_length`` is accepted and ignored;
initial states ``[L * D, B, H]`` are cast to the input's dtype; ``RNN``
runs its cell in a Python loop over time and ``BiRNN`` concatenates two
``RNN``s.  Under ``auto_cast`` the multi-layer RNN casts by its mode's
name (``lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``, on the white list);
the cells cast by theirs (``lstm_cell``, ...), which no list names.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import is_fake

from ...amp.auto_cast import cast_inputs
from .. import functional as F
from .. import initializer as I
from ..functional.common import _promoted
from ..layer_base import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU", "BiRNN"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Zeros (or ``init_value``) ``[batch, *shape]`` in the layer's
        dtype on ``batch_ref``'s device (``dtype`` is ignored, as in the
        JAX package)."""
        batch = batch_ref.shape[batch_dim_idx]
        if shape is None:
            shape = (self.hidden_size,)
        return torch.full((batch,) + tuple(shape), init_value,
                          dtype=self._dtype, device=batch_ref.device)

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _std_uniform(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


class _CellWeights(RNNCellBase):
    """A cell's ``weight_ih [G*H, in]``, ``weight_hh [G*H, H]``,
    ``bias_ih``, ``bias_hh [G*H]``, each Uniform(-1/sqrt(H), 1/sqrt(H))."""

    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _std_uniform(hidden_size)
        g = self.GATES * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], attr=weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], attr=weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], attr=bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], attr=bias_hh_attr, is_bias=True, default_initializer=init)

    def _args(self, name, inputs, *states):
        """The cell op's inputs cast by ``name`` under auto_cast, then in
        their common dtype (the JAX products promote)."""
        return _promoted(*cast_inputs(
            name, inputs, *states, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh))


class SimpleRNNCell(_CellWeights):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, wi, wh, bi, bh = self._args("simple_rnn_cell", inputs, states)
        cell = torch.rnn_tanh_cell if self.activation == "tanh" \
            else torch.rnn_relu_cell
        h = cell(x, h, wi, wh, bi, bh)
        return h, h


class LSTMCell(_CellWeights):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        x, h, c, wi, wh, bi, bh = self._args("lstm_cell", inputs, h, c)
        h_new, c_new = torch.lstm_cell(x, (h, c), wi, wh, bi, bh)
        return h_new, (h_new, c_new)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(_CellWeights):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, wi, wh, bi, bh = self._args("gru_cell", inputs, states)
        h = torch.gru_cell(x, h, wi, wh, bi, bh)
        return h, h


class RNN(Layer):
    """A cell run over a sequence in a Python loop (``is_reverse`` walks
    it backwards); returns ``(outputs, final states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        steps_axis = 0 if self.time_major else 1
        n = inputs.shape[steps_axis]
        outputs = []
        states = initial_states
        idx = range(n - 1, -1, -1) if self.is_reverse else range(n)
        for t in idx:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, states = self.cell(x_t, states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return torch.stack(outputs, dim=steps_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, s_fw)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


def _one_storage(weights) -> bool:
    """Whether ``weights`` already lie in one buffer (only
    ``_RNNBase._flatten`` puts them there)."""
    ptr = weights[0].untyped_storage().data_ptr()
    return all(w.untyped_storage().data_ptr() == ptr for w in weights[1:])


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional RNN: one ATen RNN call per
    layer (cuDNN on the card)."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        gate_mult = {"LSTM": 4, "GRU": 3}.get(self.MODE, 1)
        init = _std_uniform(hidden_size)
        # the parameters' names per layer and direction, in the JAX order
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                shapes = {"weight_ih": [gate_mult * hidden_size, in_sz],
                          "weight_hh": [gate_mult * hidden_size, hidden_size],
                          "bias_ih": [gate_mult * hidden_size],
                          "bias_hh": [gate_mult * hidden_size]}
                attrs = {"weight_ih": weight_ih_attr,
                         "weight_hh": weight_hh_attr,
                         "bias_ih": bias_ih_attr, "bias_hh": bias_hh_attr}
                names = []
                for kind, shape in shapes.items():
                    p = self.create_parameter(
                        shape, attr=attrs[kind], is_bias=kind.startswith("b"),
                        default_initializer=init)
                    self.add_parameter(kind + sfx, p)
                    names.append(kind + sfx)
                self._weight_names.append(names)

    def _flatten(self, weights, input_size):
        """Points ``weights`` into one new buffer in cuDNN's layout, as
        ``torch.nn.LSTM.flatten_parameters`` does: cuDNN then runs on
        them in place, where weights in separate tensors are copied into
        one on every call, with a warning.  The parameters move there at
        their first call on the card and stay (the optimizers and
        ``set_state_dict`` write them in place; a replaced one moves the
        layer again); the copies ``auto_cast`` makes are new on every
        call and move on every call, the one copy cuDNN would make."""
        from torch.backends.cudnn import rnn as cudnn_rnn
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                weights, 4, input_size, cudnn_rnn.get_cudnn_mode(self.MODE),
                self.hidden_size, 0, 1, not self.time_major,
                self.num_directions == 2)

    def _layer_call(self, x, hx, weights):
        """One layer, both directions: ``(outputs, h_n[, c_n])``."""
        kw = dict(has_biases=True, num_layers=1, dropout=0.0,
                  train=self.training,
                  bidirectional=self.num_directions == 2,
                  batch_first=not self.time_major)
        if (x.is_cuda and torch._use_cudnn_rnn_flatten_weight()
                and not is_fake(weights[0]) and not _one_storage(weights)):
            self._flatten(weights, x.shape[-1])
        if self.MODE == "LSTM":
            return torch._VF.lstm(x, hx, weights, *kw.values())
        fn = {"GRU": torch._VF.gru, "RNN_TANH": torch._VF.rnn_tanh,
              "RNN_RELU": torch._VF.rnn_relu}[self.MODE]
        return fn(x, hx, weights, *kw.values())

    def forward(self, inputs, initial_states=None, sequence_length=None):
        is_lstm = self.MODE == "LSTM"
        nd, nl, hs = self.num_directions, self.num_layers, self.hidden_size
        weights = [getattr(self, n) for names in self._weight_names
                   for n in names]
        if initial_states is None:
            states = ()
        elif is_lstm:
            states = tuple(initial_states)
        else:
            states = (initial_states,)
        cast = cast_inputs(self.MODE.lower(), inputs, *states, *weights)
        x = cast[0]
        states = [s.to(x.dtype) for s in cast[1:1 + len(states)]]
        weights = cast[1 + len(states):]
        batch = x.shape[1 if self.time_major else 0]
        if not states:
            zero = torch.zeros(nl * nd, batch, hs, dtype=x.dtype,
                               device=x.device)
            states = [zero, zero] if is_lstm else [zero]
        p_drop = self.dropout if self.training else 0.0
        h_last, c_last = [], []
        for layer in range(nl):
            rows = slice(layer * nd, (layer + 1) * nd)
            hx = tuple(s[rows] for s in states)
            w = weights[layer * nd * 4:(layer + 1) * nd * 4]
            out = self._layer_call(x, hx if is_lstm else hx[0], w)
            x = out[0]
            h_last.append(out[1])
            if is_lstm:
                c_last.append(out[2])
            if p_drop > 0.0 and layer < nl - 1:
                x = F.dropout(x, p_drop, training=True)
        h = torch.cat(h_last, 0)
        if is_lstm:
            return x, (h, torch.cat(c_last, 0))
        return x, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        self.MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"
