"""The case table of ``torch_op_table.py`` run against the JAX package
(``paddle_tpu_torch/ops`` against ``paddle_tpu/ops``), shared by the
``test_torch_ops_*.py`` files.

Each case is called once with ``paddle_tpu`` and once with
``paddle_tpu_torch`` on the CPU, on the same seeded numpy arrays.
Outputs must have equal dtypes and shapes; integer and boolean outputs
must be equal; floating outputs must agree within ``tol`` (1e-5 by
default, 1e-4 for linear algebra) of the reference output's largest
magnitude, NaNs in the same places. A case whose op the JAX registry
marks differentiable also runs a backward: the gradient of ``sum(out_i
* w_i)`` (seeded ``w_i``) with respect to each floating input, against
the JAX tape's, within 10 x ``tol`` of the largest reference gradient.
"""
from __future__ import annotations

import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp

from torch_op_table import CASES, compare, flat, to_numpy

__all__ = ["CASES", "run_case", "run_grad", "ops_of", "wants_grad",
           "chunks"]


def chunks(cases, n=6) -> list:
    """``cases`` in ``n`` groups of consecutive cases, at most."""
    size = -(-len(cases) // n)
    return [cases[k:k + size] for k in range(0, len(cases), size)]


def ops_of(module) -> set:
    """The JAX op names of one ``paddle_tpu.ops`` module."""
    return set(module.__all__)


def _call(P, case, grad):
    if P is jp:
        ins = [P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
               for a in case.arrays]
    else:
        ins = [tp.to_tensor(a, stop_gradient=not (
            grad and a.dtype.kind == "f")) for a in case.arrays]
    return ins, flat(case.fn(P, *ins))


def run_case(case):
    """The forward of ``case`` in both packages, compared."""
    _, want = _call(jp, case, False)
    _, got = _call(tp, case, False)
    want, got = [to_numpy(v) for v in want], [to_numpy(v) for v in got]
    if case.post is not None:
        want, got = case.post(want), case.post(got)
    assert len(got) == len(want), f"{case.name}: {len(got)} outputs, " \
        f"{len(want)} expected"
    for k, (g, w) in enumerate(zip(got, want)):
        compare(g, w, case.tol or 1e-5, f"{case.name} output {k}")
    return got


def wants_grad(case) -> bool:
    from paddle_tpu.ops import registry

    return (case.grad and registry.get_op(case.op).differentiable
            and any(a.dtype.kind == "f" for a in case.arrays))


def _grads(P, case, weights):
    ins, outs = _call(P, case, True)
    terms = []
    for o, w in zip(outs, weights):
        if w is not None:
            wt = P.to_tensor(w) if P is jp else tp.to_tensor(w)
            terms.append((o * wt).sum())
    loss = terms[0]
    for t_ in terms[1:]:
        loss = loss + t_
    if P is jp or loss.requires_grad:
        loss.backward()
    out = []
    for a, t_ in zip(case.arrays, ins):
        if a.dtype.kind != "f":
            continue
        g = t_.grad
        out.append(np.zeros_like(a) if g is None else to_numpy(g))
    return out


def run_grad(case):
    """The gradient of ``sum(out_i * w_i)`` with respect to each float
    input, in both packages, compared (10 x the case's tolerance of the
    largest reference gradient)."""
    _, outs = _call(jp, case, False)
    rng = np.random.RandomState(1)
    weights = []
    for o in outs:
        a = to_numpy(o)
        weights.append(np.asarray(rng.randn(*a.shape), a.dtype)
                       if isinstance(a, np.ndarray) and a.dtype.kind == "f"
                       else None)
    assert any(w is not None for w in weights), case.name
    want = _grads(jp, case, weights)
    got = _grads(tp, case, weights)
    for k, (g, w) in enumerate(zip(got, want)):
        compare(g, w, 10 * (case.tol or 1e-5), f"{case.name} grad {k}")
