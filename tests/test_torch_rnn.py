"""The port's recurrent layers against the JAX package's
(``paddle_tpu_torch/nn/layers/rnn.py`` against
``paddle_tpu/nn/layers/rnn.py``).

Each layer is built in both packages, the JAX ``state_dict`` carried
across by ``load_jax_params`` (the parameter names ``weight_ih_l{k}``,
``..._reverse``), and both fed the same seeded numpy inputs: f32
outputs and final states within 1e-5 of the largest value, gradients
within 1e-4.

- The cells (``SimpleRNNCell`` tanh and relu, ``LSTMCell``,
  ``GRUCell``) from given and from default states; ``RNN`` (reverse,
  time-major) and ``BiRNN`` over an ``LSTMCell`` and a ``GRUCell``.
- ``LSTM``, ``GRU`` and ``SimpleRNN`` with 2 layers, forward and
  bidirectional, batch- and time-major, from zero and from given
  initial states, with the inputs' and parameters' gradients: the
  port's fused recurrence against the JAX scan.
- C5: ``sequence_length`` is ignored by both packages (the same outputs
  with and without it, where upstream Paddle would mask the padding).
- Dropout between layers: the keep mask of each layer drawn from the
  device generator in layer order (rebuilt here from the same seed),
  none after the last layer, none in eval.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core.generator import default_generator
from paddle_tpu_torch.core.generator import seed as tseed

torch.set_num_threads(1)

B, T, IN, HID = 3, 5, 6, 8


def _pair(make, seed=0):
    paddle.seed(seed)
    j = make(jnn)
    t = make(tnn)
    load_jax_params(t, {k: np.array(v.numpy())
                        for k, v in j.state_dict().items()})
    return j, t


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.array(want.numpy() if hasattr(want, "numpy") else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _flat(states):
    if isinstance(states, (tuple, list)):
        return [s for st in states for s in _flat(st)]
    return [states]


CELLS = {"simple_tanh": lambda nn: nn.SimpleRNNCell(IN, HID),
         "simple_relu": lambda nn: nn.SimpleRNNCell(IN, HID, "relu"),
         "lstm": lambda nn: nn.LSTMCell(IN, HID),
         "gru": lambda nn: nn.GRUCell(IN, HID)}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_matches_jax(kind):
    j, t = _pair(CELLS[kind])
    x = _x(B, IN)
    h = _x(B, HID, seed=2)
    states = (h, _x(B, HID, seed=3)) if kind == "lstm" else h
    jst = tuple(paddle.to_tensor(s) for s in states) if kind == "lstm" \
        else paddle.to_tensor(states)
    tst = tuple(torch.from_numpy(s) for s in states) if kind == "lstm" \
        else torch.from_numpy(states)
    jo, jn = j(paddle.to_tensor(x), jst)
    to, tn = t(torch.from_numpy(x), tst)
    _close(to, jo, 1e-5, kind)
    for a, b in zip(_flat(tn), _flat(jn)):
        _close(a, b, 1e-5, f"{kind} state")
    # default (zero) states
    jo, _ = j(paddle.to_tensor(x))
    to, _ = t(torch.from_numpy(x))
    _close(to, jo, 1e-5, f"{kind} from zeros")


@pytest.mark.parametrize("wrapper", ["rnn", "birnn"])
def test_rnn_and_birnn_wrappers_match_jax(wrapper):
    if wrapper == "rnn":
        def make(nn):
            return nn.RNN(nn.LSTMCell(IN, HID), is_reverse=True,
                          time_major=True)
        x = _x(T, B, IN)
    else:
        def make(nn):
            return nn.BiRNN(nn.LSTMCell(IN, HID), nn.GRUCell(IN, HID))
        x = _x(B, T, IN)
    j, t = _pair(make)
    jo, jst = j(paddle.to_tensor(x))
    to, tst = t(torch.from_numpy(x))
    _close(to, jo, 1e-5, wrapper)
    for a, b in zip(_flat(tst), _flat(jst)):
        _close(a, b, 1e-5, f"{wrapper} state")


LAYERS = [("LSTM", "forward", False, True),
          ("LSTM", "bidirect", True, False),
          ("GRU", "forward", True, True),
          ("GRU", "bidirectional", False, False),
          ("SimpleRNN", "bidirect", False, True),
          ("SimpleRNN", "forward", True, False)]


@pytest.mark.parametrize("mode,direction,time_major,init", LAYERS)
def test_multi_layer_matches_jax_with_gradients(mode, direction,
                                                time_major, init):
    kw = {"activation": "relu"} if mode == "SimpleRNN" and \
        direction == "bidirect" else {}

    def make(nn):
        return getattr(nn, mode)(IN, HID, num_layers=2, direction=direction,
                                 time_major=time_major, dropout=0.3, **kw)
    j, t = _pair(make)
    j.eval()
    t.eval()
    nd = 1 if direction == "forward" else 2
    x = _x(*((T, B, IN) if time_major else (B, T, IN)))
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x).requires_grad_()
    jx.stop_gradient = False
    jinit = tinit = None
    if init:
        st = [_x(2 * nd, B, HID, seed=4 + i)
              for i in range(2 if mode == "LSTM" else 1)]
        jinit = tuple(paddle.to_tensor(s) for s in st)
        tinit = tuple(torch.from_numpy(s) for s in st)
        if mode != "LSTM":
            jinit, tinit = jinit[0], tinit[0]
    jo, jst = j(jx, jinit)
    to, tst = t(tx, tinit)
    _close(to, jo, 1e-5, "outputs")
    assert to.shape[-1] == nd * HID
    for a, b in zip(_flat(tst), _flat(jst)):
        _close(a, b, 1e-5, "final state")
    r = _x(*to.shape, seed=9)
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    _close(tx.grad, jx.grad, 1e-4, "d inputs")
    jp = dict(j.named_parameters())
    assert [n for n, _ in t.named_parameters()] == list(jp)
    for n, p in t.named_parameters():
        _close(p.grad, jp[n].grad, 1e-4, f"grad {n}")


def test_sequence_length_is_ignored_by_both_packages():
    """C5: the JAX layers ignore ``sequence_length``; so does the port,
    and both give the whole padded sequence's outputs."""
    j, t = _pair(lambda nn: nn.GRU(IN, HID, direction="bidirect"))
    x = _x(B, T, IN)
    lens = np.array([5, 3, 1], np.int64)
    jo, jh = j(paddle.to_tensor(x))
    jol, jhl = j(paddle.to_tensor(x),
                 sequence_length=paddle.to_tensor(lens))
    to, th = t(torch.from_numpy(x))
    tol, thl = t(torch.from_numpy(x), sequence_length=torch.from_numpy(lens))
    np.testing.assert_array_equal(np.array(jol.numpy()),
                                  np.array(jo.numpy()))
    assert torch.equal(tol, to) and torch.equal(thl, th)
    _close(tol, jol, 1e-5, "outputs with sequence_length")
    # upstream Paddle would hold row 2's forward state at its first step
    assert not torch.allclose(th[0, 2], to[0, 2, :HID])


def test_dropout_masks_come_from_the_generator():
    t = tnn.LSTM(IN, HID, num_layers=3, dropout=0.4)
    x = torch.from_numpy(_x(B, T, IN))
    t.eval()
    ref, _ = t(x)
    t.train()
    tseed(17)
    out, _ = t(x)
    # the same layers by hand (built first: building draws weights from
    # the generator), the masks drawn in layer order over [T, B, H]
    cells = []
    for layer in range(3):
        cell = tnn.LSTM(IN if layer == 0 else HID, HID)
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(cell, f"{name}_l0").data = \
                getattr(t, f"{name}_l{layer}").data
        cells.append(cell.eval())
    tseed(17)
    gen = default_generator("cpu")
    y = x
    for layer, cell in enumerate(cells):
        y, _ = cell(y)
        if layer < 2:
            keep = torch.rand((T, B, HID), generator=gen) < 0.6
            y = y * keep.transpose(0, 1).float() / 0.6
    torch.testing.assert_close(out, y, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(out, ref)
    t.eval()
    assert torch.equal(t(x)[0], ref)
