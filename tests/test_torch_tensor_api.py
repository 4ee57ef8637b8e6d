"""The port's tensor API surface against the JAX package's: the
inventory (every name of ``paddle_tpu.ops``, ``linalg`` and ``autograd``
has a counterpart, every registered tensor method a function), the op
registry and its call counters, the dtypes and their defaults, the
places (``set_device("cpu")`` honoured; without a card and without it,
the entry points raise), ``get_rng_state``/``set_rng_state``, and the
random ops, held by shape, dtype, device, range, moments and the
determinism of a seed (the two packages draw different numbers)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.core.place import device_guard

from torch_op_table import (CASES, RANDOM_CASES, RANDOM_N, RANDOM_OPS,
                            check_moments)

torch.set_num_threads(1)


def _name(t):
    return tp.core.dtype.convert_dtype(t.dtype).name


@pytest.fixture(autouse=True)
def _on_cpu():
    with device_guard("cpu"):
        yield


# ---------------------------------------------------------------------
# inventory and registry
# ---------------------------------------------------------------------

def test_every_jax_name_has_a_port_counterpart():
    import paddle_tpu.autograd as jautograd
    import paddle_tpu.linalg as jlinalg
    import paddle_tpu.ops as jops

    assert len(jops.__all__) == 274
    assert set(jops.__all__) == set(tp.ops.__all__)
    for n in jops.__all__:
        assert callable(getattr(tp, n)), n
    assert len(jlinalg.__all__) == 27
    assert set(jlinalg.__all__) == set(tp.linalg.__all__)
    assert tp.linalg.inv is tp.linalg.inverse
    assert set(jautograd.__all__) <= set(tp.autograd.__all__)
    for n in jautograd.__all__:
        assert hasattr(tp.autograd, n), n
    for n in ("Tensor", "Parameter", "to_tensor", "grad", "no_grad",
              "get_rng_state", "set_rng_state", "float32", "bfloat16",
              "CPUPlace", "CUDAPlace", "TPUPlace", "set_device",
              "get_device", "device_count", "is_compiled_with_tpu"):
        assert hasattr(tp, n), n
    assert tp.Tensor is torch.Tensor and tp.Parameter is torch.nn.Parameter
    assert tp.text.models.BertModel is not None


def test_every_registered_method_has_a_function():
    """The JAX package attaches its registered methods to its Tensor;
    the port keeps torch's methods and reaches each through the function
    of the same name (a dunder through torch's own operator)."""
    from paddle_tpu.ops import registry as jreg

    ops = jreg.all_ops()
    port = tp._op_registry.all_ops()
    for name in list(jp.ops.__all__) + ["increment_"]:
        if name == "to_tensor":
            continue
        jd, td = ops[name], port[name]
        assert td.methods == jd.methods, name
        assert td.differentiable == jd.differentiable, name
        assert td.inplace_of == jd.inplace_of, name
        for m in jd.methods:
            if m.startswith("__"):
                assert hasattr(torch.Tensor, m), m
            else:
                assert callable(getattr(tp.ops, m)), m
    assert set(tp._op_registry.inplace_ops()) == {"increment_", "reshape_"}


def test_every_op_has_a_case():
    covered = {c.op for c in CASES} | RANDOM_OPS | {"to_tensor"}
    assert set(jp.ops.__all__) | {"increment_"} <= covered
    assert RANDOM_OPS <= set(jp.ops.__all__)


def test_case_table_leaves_jax_out():
    """chip_smoke.py runs the table on the card, where there is no JAX."""
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    code = ("import sys; sys.path.insert(0, %r); import torch_op_table; "
            "print(','.join(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu'))))" % str(tests))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tests.parent))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_op_call_counts():
    before = tp._op_registry.op_call_counts(include_unused=True)
    x = tp.to_tensor([[1.0, 2.0]])
    tp.matmul(x, tp.transpose(x, [1, 0]))
    tp.matmul(x, x, transpose_y=True)
    after = tp._op_registry.op_call_counts()
    assert after["matmul"] - before["matmul"] == 2
    assert after["transpose"] - before["transpose"] == 1
    assert set(before) == set(tp._op_registry.all_ops())


# ---------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------

_DATA = [1, 1.0, [1.5, 2.5], np.float64(2.0), np.array([1.0]),
         np.array([1], np.int32), True, [[1, 2]], 1 + 2j]


def test_dtype_defaults_match_jax():
    for d in _DATA:
        assert _name(tp.to_tensor(d)) == jp.to_tensor(d).dtype.name, d
    assert tp.to_tensor(1).dtype == torch.int64
    assert tp.to_tensor(1.0).dtype == torch.float32
    for make in (lambda P: P.zeros([2]), lambda P: P.full([2], 3),
                 lambda P: P.full([2], True), lambda P: P.arange(3),
                 lambda P: P.arange(0.5, 2), lambda P: P.rand([2]),
                 lambda P: P.one_hot(P.to_tensor([1]), 3)):
        assert _name(make(tp)) == make(jp).dtype.name
    try:
        tp.set_default_dtype("float64")
        jp.set_default_dtype("float64")
        for make in (lambda P: P.to_tensor(1.0), lambda P: P.zeros([2]),
                     lambda P: P.arange(0.5, 2), lambda P: P.rand([2])):
            assert _name(make(tp)) == make(jp).dtype.name == "float64"
    finally:
        tp.set_default_dtype("float32")
        jp.set_default_dtype("float32")
    with pytest.raises(TypeError, match="floating"):
        tp.set_default_dtype("int32")


def test_dtype_objects_and_refused_types():
    assert tp.float32 == torch.float32 == tp.float32
    assert tp.float32 == "float32" and tp.float32 == np.float32
    assert tp.bool == torch.bool and tp.bfloat16 == "bfloat16"
    assert tp.dtype is tp.core.dtype.DType
    assert tp.core.dtype.convert_dtype(torch.int8) is tp.int8
    assert tp.int64.itemsize == 8 and tp.uint16.itemsize == 2
    # torch supports no unsigned 16/32/64-bit type in full: the port
    # refuses them, naming the type, where the JAX package takes them
    for name in ("uint16", "uint32", "uint64"):
        with pytest.raises(TypeError, match=name):
            tp.core.dtype.to_torch_dtype(name)
        with pytest.raises(TypeError, match=name):
            tp.to_tensor(np.array([1], name))
        with pytest.raises(TypeError, match=name):
            tp.cast(tp.to_tensor([1]), name)
    assert tp.to_tensor(np.array([1], np.uint8)).dtype == torch.uint8


# ---------------------------------------------------------------------
# places
# ---------------------------------------------------------------------

def test_places_and_set_device():
    assert tp.CUDAPlace is tp.TPUPlace
    assert tp.CUDAPlace(0).is_gpu_place() and tp.CUDAPlace(0).is_tpu_place()
    assert tp.CPUPlace().is_cpu_place()
    assert tp.is_compiled_with_tpu() is False
    assert tp.get_device() == "cpu"
    assert tp.to_tensor([1.0]).device.type == "cpu"
    assert tp.to_tensor([1.0], place=tp.CPUPlace()).device.type == "cpu"
    with device_guard("gpu:1") as p:
        assert p == tp.CUDAPlace(1) and tp.get_device() == "gpu:1"
        assert tp.core.device.resolve_device() == torch.device("cuda", 1)
    assert tp.get_device() == "cpu"
    with pytest.raises(ValueError, match="unknown device"):
        tp.set_device("xpu")


def test_without_a_card_and_unasked_the_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tplace, "_current_place", None)
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.core.device import resolve_device

    for call in (lambda: tp.to_tensor([1.0]), lambda: tp.zeros([2]),
                 lambda: tp.arange(3), lambda: tp.rand([2]),
                 lambda: tp.get_device(), lambda: resolve_device(),
                 lambda: bench.run_bert_bench(1, 128, 1),
                 lambda: bench.make_bert_train_step(128)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for the CPU, they run
    assert tp.to_tensor([1.0], place="cpu").device.type == "cpu"
    tp.set_device("cpu")
    assert tp.zeros([2]).device.type == "cpu"


# ---------------------------------------------------------------------
# generators and the random ops
# ---------------------------------------------------------------------

def test_rng_state_replays_the_draws():
    tp.seed(7)
    tp.rand([3])
    state = tp.get_rng_state()
    a = [tp.rand([4]), tp.randn([2, 2]), tp.randint(0, 9, [5])]
    tp.rand([8])
    tp.set_rng_state(state)
    b = [tp.rand([4]), tp.randn([2, 2]), tp.randint(0, 9, [5])]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    tp.seed(7)
    c = tp.rand([3])
    tp.seed(7)
    assert torch.equal(c, tp.rand([3]))
    g = tp.core.generator.Generator(5)
    s = g.get_state()
    u1 = torch.rand(3, generator=g.generator)
    g.set_state(s)
    assert torch.equal(u1, torch.rand(3, generator=g.generator))
    assert g.initial_seed() == 5


def test_random_ops_shapes_dtypes_moments_and_seed():
    failed = []
    for name, (call, support, mean, std) in sorted(RANDOM_CASES.items()):
        try:
            small_t, small_j = call(tp, 6), call(jp, 6)
            assert tuple(small_t.shape) == tuple(small_j.shape), "shape"
            assert _name(small_t) == small_j.dtype.name, "dtype"
            assert small_t.device.type == "cpu", "device"
            tp.seed(11)
            x = call(tp, RANDOM_N)
            tp.seed(11)
            assert torch.equal(x, call(tp, RANDOM_N)), "seed"
            check_moments(x, support, mean, std)
        except AssertionError as e:
            failed.append(f"{name}: {e}")
    assert not failed, failed


def test_random_draws_come_from_the_port_generator():
    """torch's global generator is not read: reseeding it changes no
    draw, and the port's seed does."""
    tp.seed(3)
    a = tp.rand([5])
    torch.manual_seed(123)
    tp.seed(3)
    assert torch.equal(a, tp.rand([5]))
    tp.seed(4)
    assert not torch.equal(a, tp.rand([5]))
