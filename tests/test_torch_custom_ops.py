"""The port's kernels as ``torch.library`` ops (namespace ``ptt``).

Every op ``_kernels.define_op`` registered goes through
``torch.library.opcheck`` on small CPU inputs, where its implementation
runs the kernel's plain version: the schema (declared in-place writes,
no undeclared mutation or aliasing), the fake implementation against the
real outputs (shapes, dtypes, strides), the autograd registration of the
ops with a gradient (B10's and B11's forwards, B14's forward mode) with
inputs that need one, and an AOT trace with dynamic shapes. The cases
are ``paddle_tpu_torch._op_cases.CASES``, grouped by kernel family, one
test each. Then every op runs under a
``FakeTensorMode`` on CUDA fake tensors, with ``data_ptr``, the kernel
libraries and the wrappers' host-side planning refused: a fake tensor
never reaches a launch. Last, ``_kernels.call``: a wrapper dispatches its
op only where something would see the op.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch import _kernels
from paddle_tpu_torch._op_cases import CASES
from paddle_tpu_torch.nn.functional import attention as at
from paddle_tpu_torch.nn.functional import flash_varlen as fv
from paddle_tpu_torch.nn.functional import grouped_gemm as gg
from paddle_tpu_torch.nn.functional import paged_attention as pa
from paddle_tpu_torch.nn.functional import stream_linear as sl

torch.set_num_threads(1)


def test_every_registered_op_has_a_case():
    """``_op_cases.CASES`` covers every op the kernels' modules registered:
    19 ops covering each CUDA entry of B1-B16 (B2's GEMM; B3's tail,
    its four GEMMs and two LayerNorms; B10's and B11's forward, dq and
    dk/dv; B14's two modes and B15)."""
    gen = torch.Generator().manual_seed(0)
    covered = {op for make in CASES.values() for op, _ in make(gen)}
    ops = set(_kernels.registered_ops())
    assert covered == ops
    assert len(ops) == 19
    assert all(str(op).startswith("ptt.") for op in ops)


@pytest.mark.parametrize("family", sorted(CASES))
def test_opcheck(family):
    gen = torch.Generator().manual_seed(1)
    for op, args in CASES[family](gen):
        torch.library.opcheck(op, args)


def test_fake_cuda_tensors_never_reach_a_launch(monkeypatch):
    """Under a ``FakeTensorMode`` with CUDA fake operands every op gives
    outputs of the fake implementation's shapes and dtypes on the card
    device, and reaches no data pointer, no kernel library, no stream and
    none of the wrappers' host-side planning (``_decode_split``,
    ``_split_buffers``, ``_card_maps``, the B14/B15 work maps)."""
    gen = torch.Generator().manual_seed(2)
    cases = [c for make in CASES.values() for c in make(gen)]

    def refuse(*a, **k):
        raise AssertionError("a fake tensor reached the launch path")
    monkeypatch.setattr(torch.Tensor, "data_ptr", refuse)
    for mod, names in ((_kernels, ("lib", "stream_ptr", "sm_count")),
                       (pa, ("_decode_split",)), (sl, ("_split_buffers",)),
                       (fv, ("_card_maps", "varlen_block_map")),
                       (gg, ("kernel_work_map", "kernel_dw_tile_order"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    with FakeTensorMode():
        for op, args in cases:
            fake = tuple(torch.empty_strided(a.shape, a.stride(),
                                             dtype=a.dtype, device="cuda")
                         if isinstance(a, torch.Tensor) else a
                         for a in args)
            outs = op(*fake)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            assert outs and all(o.device.type == "cuda" for o in outs), op


def test_wrappers_dispatch_only_where_the_op_is_seen(monkeypatch):
    """``_kernels.call``: in plain eager code a wrapper runs its op's
    implementation itself; under a dispatch mode (as export and fake
    tensors trace) the wrapper calls the op, which the mode records, and
    the dispatcher runs the same implementation. Both give the plain
    version's result on the CPU. An op with a gradient (B10's forward)
    always dispatches."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 64, generator=gen)
    w = torch.randn(64, 32, generator=gen)
    want = sl._stream_linear_plain(x, w)
    direct = []
    impl = _kernels._IMPLS[sl._gemm_op]
    monkeypatch.setitem(_kernels._IMPLS, sl._gemm_op,
                        lambda *a: direct.append(a[0]) or impl(*a))
    torch.testing.assert_close(sl.stream_linear(x, w), want, rtol=0, atol=0)
    assert len(direct) == 1 and direct[0] is x

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))
    with Record():
        got = sl.stream_linear(x, w)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(direct) == 1 and "ptt.stream_gemm.default" in seen
    assert at._fwd_op not in _kernels._IMPLS
    assert sl._tail_op in _kernels._IMPLS
