"""The port's elementwise math against the JAX package's
(``paddle_tpu_torch/ops/math.py`` against ``paddle_tpu/ops/``), one case
at a time from the shared table ``torch_op_table.py`` (run by
``torch_op_cases.py``): the same Paddle code on the same seeded numpy
inputs in both packages, outputs of equal dtype and shape, integers and
booleans equal, floats within 1e-5 of the largest reference magnitude;
the gradient of each differentiable op against the JAX tape's within 10x
that tolerance of the largest reference gradient. The cases run in at
most six groups a test, so that the file keeps few tests (see
ROADMAP.md's constraints on the tier-1 wall); a group reports every case
that fails."""
import pytest
import torch

import paddle_tpu.ops as jops
from paddle_tpu_torch.core.place import device_guard

from torch_op_cases import (CASES, chunks, ops_of, run_case, run_grad,
                            wants_grad)

torch.set_num_threads(1)

_OPS = (set(jops.math._UNARY) | set(jops.math._BINARY)
        | {"scale", "clip", "lerp", "stanh", "addmm", "multiplex"})
_CASES = [c for c in CASES if c.op in _OPS]


@pytest.fixture(autouse=True)
def _on_cpu():
    with device_guard("cpu"):
        yield


@pytest.mark.parametrize("part", chunks(_CASES), ids=lambda p: p[0].name)
def test_ops_match_jax(part):
    failed = []
    for case in part:
        try:
            run_case(case)
        except AssertionError as e:
            failed.append(f"{case.name}: {e}")
    assert not failed, failed


@pytest.mark.parametrize("part", chunks([c for c in _CASES if wants_grad(c)]),
                         ids=lambda p: p[0].name)
def test_op_gradients_match_jax(part):
    failed = []
    for case in part:
        try:
            run_grad(case)
        except AssertionError as e:
            failed.append(f"{case.name}: {e}")
    assert not failed, failed
