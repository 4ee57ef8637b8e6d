"""``jit.to_static`` of the port against the JAX package's, on the CPU.

- The program cache: over one call sequence (eval and train, another
  batch size, grad mode off, a static keyword changed, an input that
  wants a gradient) on a small conv net with BN, carried across with
  ``load_jax_params``, ``program_cache`` holds as many programs after
  each call in both packages, and ``jit.trace`` and ``jit.cache_hit``
  of ``profiler.stats`` moved by the same counts (exact). The outputs
  equal the port's eager outputs (the same code runs: exact) and the
  JAX package's within 1e-5; a training call's gradients flow to the
  parameters.
- ``GraphBreakError`` for ``if tensor:`` and for ``.item()`` inside the
  function, naming the function and this file's line, in both
  packages; the program stays in the cache and raises again.
- ``rollback`` restores the eager forward: later calls leave the cache
  and the counters alone.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn
from paddle_tpu.jit.graph_break import GraphBreakError as JGraphBreakError
import paddle_tpu_torch.jit as tjit
import paddle_tpu_torch.nn as tnn
from paddle_tpu.profiler import stats as jstats
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.profiler import stats as tstats

torch.set_num_threads(1)


def _net(nn):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.bn = nn.BatchNorm2D(4)
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.fc = nn.Linear(4, 2)

        def forward(self, x, scale=1.0):
            h = self.pool(nn.functional.relu(self.bn(self.conv(x))))
            return self.fc(h.flatten(1)) * scale
    return Net()


def _counts(stats):
    return (stats.counter("jit.trace").value,
            stats.counter("jit.cache_hit").value)


def test_program_cache_and_counters_match_jax():
    jm, tm = _net(jnn), _net(tnn)
    arrays = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    load_jax_params(tm, arrays)
    jm, tm = jjit.to_static(jm), tjit.to_static(tm)
    r = np.random.RandomState(0)
    x2 = r.randn(2, 3, 6, 6).astype(np.float32)
    x4 = r.randn(4, 3, 6, 6).astype(np.float32)
    # (mode, input, grad enabled, scale, input wants a gradient)
    calls = [("eval", x2, True, 1.0, False), ("eval", x2, True, 1.0, False),
             ("eval", x4, True, 1.0, False), ("eval", x2, False, 1.0, False),
             ("eval", x2, False, 1.0, False), ("eval", x2, True, 2.0, False),
             ("train", x2, True, 1.0, False), ("train", x2, True, 1.0, False),
             ("train", x2, True, 1.0, True), ("eval", x2, True, 1.0, False),
             ("train", x4, True, 1.0, False)]
    j0, t0 = _counts(jstats), _counts(tstats)
    for i, (mode, x, grad, scale, wants) in enumerate(calls):
        for m in (jm, tm):
            m.train() if mode == "train" else m.eval()
        jx = paddle.to_tensor(x, stop_gradient=not wants)
        tx = torch.from_numpy(x).requires_grad_(wants)
        if grad:
            jo = jm(jx, scale=scale)
            to = tm(tx, scale=scale)
        else:
            with paddle.no_grad():
                jo = jm(jx, scale=scale)
            with torch.no_grad():
                to = tm(tx, scale=scale)
        np.testing.assert_allclose(to.detach().numpy(),
                                   np.array(jo.numpy()), atol=1e-5, rtol=0,
                                   err_msg=str(i))
        if mode == "train" and grad:
            to.sum().backward()
            assert tm.fc.weight.grad is not None
            if wants:
                assert tx.grad is not None and tx.grad.shape == tx.shape
            tm.zero_grad()
        jn, tn = _counts(jstats), _counts(tstats)
        assert len(tm.forward.program_cache) == \
            len(jm.forward.program_cache), i
        assert (tn[0] - t0[0], tn[1] - t0[1]) == \
            (jn[0] - j0[0], jn[1] - j0[1]), i
    assert len(tm.forward.program_cache) == 7
    # the cached path's output is the eager forward's, bitwise
    tm.eval()
    x = torch.from_numpy(x2)
    with torch.no_grad():
        assert torch.equal(tm(x), tm.forward._orig_fn(x))


def _branchy(x):
    if x.sum() > 0:
        return x * 2
    return x


def _reads(x):
    return x * x.mean().item()


@pytest.mark.parametrize("fn", [_branchy, _reads],
                         ids=["if_tensor", "item"])
def test_graph_break_names_the_users_line(fn):
    line = inspect.getsourcelines(fn)[1] + 1
    x = np.ones((2, 3), np.float32)
    with pytest.raises(JGraphBreakError) as jexc:
        jjit.to_static(fn)(paddle.to_tensor(x))
    assert f"test_torch_to_static.py:{line}" in str(jexc.value)
    sf = tjit.to_static(fn)
    for _ in range(2):
        with pytest.raises(tjit.GraphBreakError) as texc:
            sf(torch.from_numpy(x))
        msg = str(texc.value)
        assert f"`{fn.__name__}`" in msg
        assert f"test_torch_to_static.py:{line}" in msg
    assert len(sf.program_cache) == 1


def test_rollback_restores_eager():
    tm = tjit.to_static(_net(tnn))
    tm.eval()
    x = torch.randn(2, 3, 6, 6)
    with torch.no_grad():
        tm(x)
        sf = tm.forward
        assert len(sf.program_cache) == 1
        eager = sf.rollback()
        before = _counts(tstats)
        out = tm(x)
    assert tm.forward is eager
    assert _counts(tstats) == before and len(sf.program_cache) == 1
    assert sf(x).shape == out.shape and _counts(tstats) == before


class _Replayed:
    def __init__(self, fn):
        self.replay = fn


def _one_slot_graphs():
    """A ``_Graphs`` whose captured forward is ``y = (x + noise)^2 * c``
    (noise from a generator, ``c = 1 + n`` with the buffer ``n`` counting
    forwards) and whose backward reads the one activation slot that
    every forward overwrites and the backward clobbers, as a captured
    program's saved activations live in its one memory pool."""
    from paddle_tpu_torch.jit import static_function as sfm

    g = object.__new__(sfm._Graphs)
    g.state, g.ptrs, g.tick, g.held = [], [], 0, None
    g.buffers, g.gens = [torch.zeros(())], [torch.Generator().manual_seed(5)]
    g.static_args = [torch.zeros(4, requires_grad=True)]
    g.diff_out, g.outs = [0], [torch.zeros(4)]
    g.grad_out, g.grads = [torch.zeros(4)], [torch.zeros(4)]
    slot = {}

    def fwd():
        h = g.static_args[0].detach() + torch.rand(4, generator=g.gens[0])
        slot["h"], slot["c"] = h, 1.0 + g.buffers[0].item()
        g.outs[0].copy_(h * h * slot["c"])
        g.buffers[0] += 1

    def bwd():
        g.grads[0].copy_(g.grad_out[0] * 2 * slot["h"] * slot["c"])
        slot["h"] = torch.full((4,), float("nan"))

    g.fwd, g.bwd = _Replayed(fwd), _Replayed(bwd)
    return g


def _eager_one_slot(xs, weights):
    gen, n, loss = torch.Generator().manual_seed(5), 0, 0.0
    for x, w in zip(xs, weights):
        h = x + torch.rand(4, generator=gen)
        loss = loss + w * (h * h * (1.0 + n)).sum()
        n += 1
    loss.backward()


def test_forwards_before_one_backward_replay_their_own_activations():
    """Two calls of one captured program before one backward (two views
    of a batch in one loss): each call's gradient comes from its own
    arguments, buffers and noise, the later call's from the activations
    in the pool and the earlier one's from a replay of its forward, which
    leaves the buffers and the generator as the two calls left them;
    then a backward twice (its activations consumed) replays again."""
    from paddle_tpu_torch.jit.static_function import _Replay

    g = _one_slot_graphs()
    r = np.random.RandomState(3)
    data = [r.randn(4).astype(np.float32) for _ in range(2)]
    xs = [torch.from_numpy(d).requires_grad_(True) for d in data]
    ys = [_Replay.apply(g, 1, x)[0] for x in xs]
    (ys[0].sum() + 3.0 * ys[1].sum()).backward()
    after = (g.buffers[0].item(), g.gens[0].get_state())
    refs = [torch.from_numpy(d).requires_grad_(True) for d in data]
    _eager_one_slot(refs, (1.0, 3.0))
    for x, ref in zip(xs, refs):
        torch.testing.assert_close(x.grad, ref.grad, rtol=1e-6, atol=0)
    ref_gen = torch.Generator().manual_seed(5)
    torch.rand(8, generator=ref_gen)
    assert after[0] == 2.0 and torch.equal(after[1], ref_gen.get_state())
    # one call, its backward twice: the second finds the slot clobbered
    g = _one_slot_graphs()
    x = torch.from_numpy(data[0]).requires_grad_(True)
    y = _Replay.apply(g, 1, x)[0].sum()
    y.backward(retain_graph=True)
    first = x.grad.clone()
    y.backward()
    torch.testing.assert_close(x.grad, 2 * first, rtol=1e-6, atol=0)
    assert g.buffers[0].item() == 1.0
