"""Recurrent layers (counterpart of ``paddle_tpu/nn/layers/rnn.py``): the
cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the ``RNN`` and
``BiRNN`` wrappers that step a cell over a sequence, and the stacked
``SimpleRNN``, ``LSTM`` and ``GRU``.

Weights follow Paddle (and cuDNN): ``weight_ih`` ``[gates * hidden,
input]``, ``weight_hh`` ``[gates * hidden, hidden]``, gate order LSTM
(i, f, g, o), GRU (r, z, c) with the reset gate applied to ``W_hc h +
b_hc``; the stacked layers name theirs ``weight_ih_l{k}{suffix}``,
``weight_hh_l{k}{suffix}``, ``bias_ih_l{k}{suffix}``,
``bias_hh_l{k}{suffix}`` (suffix ``_reverse`` for the backward
direction), so ``convert.load_jax_params`` carries a JAX layer across.

The cells are plain PyTorch ops. The stacked layers run one layer at a
time through PyTorch's fused recurrence (``torch._VF.lstm``, ``gru``,
``rnn_tanh``, ``rnn_relu``: cuDNN on the card, the native loop on the
CPU), both directions of a layer in one call; the JAX package runs a
``scan`` there and has no kernel of its own for it. Dropout between
layers draws its keep mask from the device's default generator
(``core.generator``), one layer at a time, never from cuDNN's own
dropout state.

``sequence_length`` is accepted and ignored, as by every JAX layer:
the outputs and final states are those of the whole padded sequence
(ROADMAP C5).
"""
from __future__ import annotations

import math

import torch

from ...core.generator import default_generator
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU", "RNNCellBase"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` for the batch of ``batch_ref`` (its
        ``batch_dim_idx`` axis), one per entry of ``state_shape``, in
        ``dtype`` (f32 by default) on ``batch_ref``'s device."""
        batch = batch_ref.shape[batch_dim_idx]
        dt = I.to_dtype(dtype or "float32")

        def full(s):
            return torch.full([batch] + list(s), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(self.state_shape[0], (list, tuple)):
            return tuple(full(s) for s in self.state_shape)
        return full(self.state_shape)


def _uniform(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-std, std)


def _cell_params(layer, input_size, hidden_size, gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
    u = _uniform(hidden_size)
    layer.weight_ih = layer.create_parameter(
        [gates * hidden_size, input_size], weight_ih_attr,
        default_initializer=u)
    layer.weight_hh = layer.create_parameter(
        [gates * hidden_size, hidden_size], weight_hh_attr,
        default_initializer=u)
    layer.bias_ih = layer.create_parameter(
        [gates * hidden_size], bias_ih_attr, is_bias=True,
        default_initializer=u)
    layer.bias_hh = layer.create_parameter(
        [gates * hidden_size], bias_hh_attr, is_bias=True,
        default_initializer=u)


def _lstm_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    z = x @ w_ih.T + h @ w_hh.T + b_ih + b_hh
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(x, h, w_ih, w_hh, b_ih, b_hh):
    xr, xu, xc = (x @ w_ih.T + b_ih).chunk(3, dim=-1)
    hr, hu, hc = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    c = torch.tanh(xc + r * hc)
    return (1 - u) * c + u * h


def _rnn_step(x, h, w_ih, w_hh, b_ih, b_hh, activation):
    z = x @ w_ih.T + h @ w_hh.T + b_ih + b_hh
    return torch.tanh(z) if activation == "tanh" else torch.relu(z)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(W_ih x + b_ih + W_hh h + b_hh)``, ``act`` tanh or
    relu; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = _rnn_step(inputs, states, self.weight_ih, self.weight_hh,
                        self.bias_ih, self.bias_hh, self.activation)
        return out, out


class LSTMCell(RNNCellBase):
    """One LSTM step; ``states`` is ``(h, c)``; returns ``(h', (h',
    c'))``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h_new, c_new = _lstm_step(inputs, h, c, self.weight_ih,
                                  self.weight_hh, self.bias_ih, self.bias_hh)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    """One GRU step; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = _gru_step(inputs, states, self.weight_ih, self.weight_hh,
                        self.bias_ih, self.bias_hh)
        return out, out


class RNN(Layer):
    """``cell`` stepped over the time axis of ``inputs`` (axis 1, or 0
    with ``time_major``), backwards with ``is_reverse`` (outputs kept in
    input order); returns ``(outputs, final states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        order = range(steps - 1, -1, -1) if self.is_reverse \
            else range(steps)
        states, outs = initial_states, []
        for t in order:
            out, states = self.cell(inputs.select(time_axis, t), states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=time_axis), states


class BiRNN(Layer):
    """A forward and a reverse ``RNN``; outputs concatenated on the last
    axis, states ``(forward's, backward's)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, fin_fw = self.rnn_fw(inputs, st_fw)
        out_bw, fin_bw = self.rnn_bw(inputs, st_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (fin_fw, fin_bw)


#: the fused recurrence of each mode
_FUSED = {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru,
          "RNN_TANH": torch._VF.rnn_tanh, "RNN_RELU": torch._VF.rnn_relu}


class _MultiLayerRNN(Layer):
    """Stacked, optionally bidirectional recurrence: a fused call a
    layer, dropout between layers in training."""

    MODE_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        if direction == "forward":
            self.num_directions = 1
        elif direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        else:
            raise ValueError(f"unknown direction {direction!r}")
        self.direction = direction
        gates = self.MODE_GATES[mode]
        u = _uniform(hidden_size)
        self._param_names = []
        attrs = [weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr]
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 \
                else hidden_size * self.num_directions
            for d in range(self.num_directions):
                suffix = "_reverse" if d == 1 else ""
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}",
                         f"bias_ih_l{layer}{suffix}",
                         f"bias_hh_l{layer}{suffix}"]
                shapes = [[gates * hidden_size, in_sz],
                          [gates * hidden_size, hidden_size],
                          [gates * hidden_size], [gates * hidden_size]]
                for n, s, a in zip(names, shapes, attrs):
                    self.add_parameter(n, self.create_parameter(
                        s, a, is_bias=len(s) == 1, default_initializer=u))
                self._param_names.append(names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        nl, nd, hs = self.num_layers, self.num_directions, self.hidden_size
        lstm = self.mode == "LSTM"
        x = inputs if self.time_major else inputs.transpose(0, 1)
        if initial_states is None:
            h0 = torch.zeros((nl * nd, x.shape[1], hs), dtype=x.dtype,
                             device=x.device)
            c0 = h0
        elif lstm:
            h0, c0 = initial_states
        else:
            h0 = initial_states
        fused = _FUSED[self.mode]
        p = self.dropout if self.training else 0.0
        train = torch.is_grad_enabled()
        h_fin, c_fin = [], []
        for layer in range(nl):
            params = [self._parameters[n]
                      for names in self._param_names[layer * nd:
                                                     (layer + 1) * nd]
                      for n in names]
            rows = slice(layer * nd, (layer + 1) * nd)
            if lstm:
                x, h, c = fused(x, (h0[rows], c0[rows]), params, True, 1,
                                0.0, train, nd == 2, False)
                c_fin.append(c)
            else:
                x, h = fused(x, h0[rows], params, True, 1, 0.0, train,
                             nd == 2, False)
            h_fin.append(h)
            if p > 0.0 and layer < nl - 1:
                keep = torch.rand(x.shape, device=x.device,
                                  generator=default_generator(x.device)) \
                    < 1.0 - p
                x = x * keep.to(x.dtype) / (1.0 - p)
        out = x if self.time_major else x.transpose(0, 1)
        h = torch.cat(h_fin, dim=0)
        return (out, (h, torch.cat(c_fin, dim=0))) if lstm else (out, h)


class SimpleRNN(_MultiLayerRNN):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_MultiLayerRNN):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_MultiLayerRNN):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
