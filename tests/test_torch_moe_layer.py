"""Parity of paddle_tpu_torch's MoELayer with paddle_tpu's.

Each JAX layer is built from a seed and its weights are carried into the
port's layer with ``load_jax_params``; both see the same seeded numpy
input. Outputs are held to JAX's within 1e-5 of the largest value and
``aux_loss`` within 1e-6 relative (f32 sums in another order); the
routing telemetry (``moe.dropped_tokens``, ``moe.tokens_per_expert``,
``moe.imbalance``) is integer data and equal. One ``TrainStep`` of each
formulation (no-drop, capacity) leaves every parameter within 2e-4
relative of the JAX step's (the tolerance of the JAX package's own
formulation test) plus 1e-5 absolute, a thousandth of the learning
rate: Adam's first step moves an entry by ``lr * g / (|g| + eps)``, so
an entry whose gradient is of the order of eps (measured: 4.6e-8, where
the largest is 8.3e-3) moves by an amount that the gradients' f32
rounding noise sets (2.5e-6 measured on one of 2048 entries).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.incubate.moe import MoELayer as JMoELayer
from paddle_tpu.nn import initializer as JI
from paddle_tpu.profiler import stats as jstats
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.incubate.moe import MoELayer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import stats as tstats

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

D, E, DFF = 16, 4, 32


def _x(seed=1, shape=(8, 4, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _skewed_gate():
    """Expert 2 wins every token by a mile, expert 0 is the runner-up."""
    wg = np.full((D, E), -10.0, np.float32)
    wg[:, 2] = 10.0
    wg[:, 0] = 9.0
    return wg


def _pair(seed=0, gate_w=None, experts=None, **kw):
    """(JAX layer, port layer with the JAX layer's weights)."""
    paddle.seed(seed)
    jl = JMoELayer(d_model=D, num_experts=E, d_hidden=DFF,
                   experts=experts and [jnn.Linear(D, D) for _ in range(E)],
                   **kw)
    if gate_w is not None:
        jl.gate.weight._rebind(jnp.asarray(gate_w))
    tl = MoELayer(D, num_experts=E, d_hidden=DFF, device="cpu",
                  experts=experts and [tnn.Linear(D, D) for _ in range(E)],
                  **kw)
    load_jax_params(tl, {n: np.asarray(p._data)
                         for n, p in jl.state_dict().items()})
    return jl, tl


def _stats_of(mod):
    snap = mod.snapshot("moe.")
    hist = snap["histograms"].get("moe.tokens_per_expert", {})
    return (snap["counters"].get("moe.dropped_tokens", 0),
            {k: hist.get(k) for k in ("count", "total", "min", "max")},
            snap["gauges"].get("moe.imbalance"))


#: (name, constructor options, gate weights): the no-drop path, the
#: capacity path with ample room and under skew (drops), the naive and
#: switch gates (capacity path), and a list of per-expert layers
LAYERS = {
    "nodrop": (dict(gate="gshard", capacity_factor=None), None, False),
    "capacity": (dict(gate="gshard", capacity_factor=float(E)), None, False),
    "capacity_drops": (dict(gate="gshard", capacity_factor=1.0),
                       "skewed", False),
    "nodrop_skewed": (dict(gate="gshard", capacity_factor=None), "skewed",
                      False),
    "naive": (dict(gate="naive", capacity_factor=1.25), None, False),
    "switch": (dict(gate="switch", capacity_factor=1.25), None, False),
    "experts_list": (dict(gate="gshard", capacity_factor=2.0), None, True),
}


@pytest.fixture(scope="module")
def forwards():
    """Each layer once per package: output, aux_loss and the moe.*
    telemetry of one eager forward."""
    res = {}
    x = _x()
    for name, (kw, gate, experts) in LAYERS.items():
        jl, tl = _pair(gate_w=_skewed_gate() if gate else None,
                       experts=experts, **kw)
        jstats.reset()
        tstats.reset()
        jy = np.asarray(jl(paddle.to_tensor(x))._data)
        ty = tl(torch.from_numpy(x))
        res[name] = {"jax": (jy, float(np.asarray(jl.aux_loss._data)),
                             _stats_of(jstats), jl),
                     "port": (ty, float(tl.aux_loss.detach()),
                              _stats_of(tstats),
                              tl)}
    return res


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_forward_and_aux_loss_match_jax(forwards, name):
    jy, jaux, _, jl = forwards[name]["jax"]
    ty, taux, _, tl = forwards[name]["port"]
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    limit = 1e-5 * max(float(np.abs(jy).max()), 1e-6)
    assert float(np.abs(ty.detach().numpy() - jy).max()) <= limit
    assert math.isclose(taux, jaux, rel_tol=1e-6, abs_tol=1e-9)
    assert tl.top_k == jl.top_k
    assert tl.capacity_factor == jl.capacity_factor
    assert getattr(tl.gate, "aux_loss_weight", 0.0) == \
        getattr(jl.gate, "aux_loss_weight", 0.0)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_telemetry_matches_jax(forwards, name):
    """Dropped assignments, the per-expert histogram and the imbalance
    gauge of one eager forward are JAX's, number for number."""
    assert forwards[name]["port"][2] == forwards[name]["jax"][2]


def test_drops_counted_on_the_capacity_path_only(forwards):
    drops = {n: forwards[n]["port"][2][0] for n in
             ("capacity_drops", "nodrop_skewed", "capacity")}
    assert drops["capacity_drops"] > 0
    assert drops["nodrop_skewed"] == 0 and drops["capacity"] == 0
    # every one of the 32 tokens' 2 assignments still reaches an expert
    hist = forwards["nodrop_skewed"]["port"][2][1]
    assert hist["count"] == E and hist["total"] == 64


def test_gates_route_as_named():
    for gate, k, w in (("naive", 2, 0.0), ("gshard", 2, 1e-2),
                       ("switch", 1, 1e-2)):
        layer = MoELayer(D, num_experts=E, gate=gate, d_hidden=DFF,
                         device="cpu")
        assert layer.top_k == k and layer.gate.top_k == k
        assert getattr(layer.gate, "aux_loss_weight") == w
        assert layer.gate.weight.shape == (D, E)


@pytest.mark.parametrize("cf", [None, float(E)])
def test_train_step_matches_jax(cf):
    """One AdamW step through each package's TrainStep from the same
    weights: every parameter within 2e-4 relative and 1e-5 absolute of
    the JAX step's (module docstring)."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 4, D).astype(np.float32)
    y = rng.randn(4, 4, D).astype(np.float32)
    jl, tl = _pair(seed=7, gate="gshard", capacity_factor=cf)
    opt = paddle.optimizer.AdamW(1e-2, parameters=jl.parameters())
    paddle.jit.TrainStep(jl, lambda o, t: ((o - t) ** 2).mean(), opt)(
        [paddle.to_tensor(x)], [paddle.to_tensor(y)])
    step = TrainStep(tl, lambda o, t: ((o - t) ** 2).mean(),
                     AdamW(1e-2, parameters=tl.parameters()))
    tstats.reset()
    step([torch.from_numpy(x)], [torch.from_numpy(y)])
    # the step stamps no telemetry (the JAX step's trace does not either)
    assert tstats.histogram("moe.tokens_per_expert").count == 0
    want = {n: np.asarray(p._data) for n, p in jl.named_parameters()}
    got = dict(tl.named_parameters())
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].detach().numpy(), w, rtol=2e-4,
                                   atol=1e-5, err_msg=n)


def test_xavier_uniform_bounds_match_jax():
    """The expert bank's initializer: uniform within the JAX fan rule's
    limit (a 3-D [E, d, d_ff] bank: fan_in d * d_ff, fan_out E * d_ff),
    filling it, as the JAX initializer does."""
    shape = (E, D, DFF)
    limit = math.sqrt(6.0 / (D * DFF + E * DFF))
    assert math.isclose(TI.XavierUniform().limit(shape), limit)
    paddle.seed(3)
    jw = np.asarray(JI.XavierUniform()(shape))
    torch.manual_seed(3)
    tw = TI.XavierUniform()(shape).numpy()
    for w in (jw, tw):
        assert w.dtype == np.float32 and w.shape == shape
        assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
        assert abs(float(w.mean())) < 0.05 * limit
    layer = MoELayer(D, num_experts=E, d_hidden=DFF, device="cpu")
    assert float(layer.stacked.w1.detach().abs().max()) <= limit
    assert (layer.stacked.b1 == 0).all()


def test_entry_point_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(D, num_experts=E, d_hidden=DFF)
    with pytest.raises(NotImplementedError, match="A8"):
        MoELayer(D, num_experts=E, d_hidden=DFF, ep_mesh=("mesh", "ep"),
                 device="cpu")
    with pytest.raises(ValueError, match="stacked ExpertFFN"):
        MoELayer(D, experts=[tnn.Linear(D, D) for _ in range(E)],
                 capacity_factor=None, device="cpu")(torch.zeros(2, D))
