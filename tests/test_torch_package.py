"""Boundaries of the PyTorch/CUDA port (paddle_tpu_torch).

The port imports torch and never JAX or the JAX package, neither does
chip_smoke.py, its entry points refuse to fall back to the CPU without
being asked, and nothing builds a kernel when only CPU tensors flow.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"


def _port_sources():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) \
        + sorted(PKG.rglob("*.cuh")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if "_build" not in f.parts]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.inference, "
        "paddle_tpu_torch.convert, paddle_tpu_torch._kernels\n"
        "import paddle_tpu_torch.nn.functional.paged_attention\n"
        "from paddle_tpu_torch.nn.functional.paged_attention import (\n"
        "    paged_attention, last_paged_attention_backend, stream_paged,\n"
        "    fused_paged, pallas_paged, pool_membership,\n"
        "    build_pool_ownership)\n"
        "from paddle_tpu_torch.core.flags import get_flags\n"
        "assert get_flags('FLAGS_paged_attention_backend') == "
        "{'FLAGS_paged_attention_backend': 'auto'}\n"
        "import paddle_tpu_torch.nn.functional.stream_linear\n"
        "import paddle_tpu_torch.nn.functional.flash_varlen\n"
        "import paddle_tpu_torch.nn.functional.grouped_gemm\n"
        "import paddle_tpu_torch.nn.functional.lora\n"
        "import paddle_tpu_torch.serving.adapters\n"
        "import paddle_tpu_torch.quantization\n"
        "import paddle_tpu_torch.serving\n"
        "import paddle_tpu_torch.nn.functional.attention\n"
        "import paddle_tpu_torch.nn, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.bench\n"
        "import paddle_tpu_torch.incubate.moe\n"
        "import paddle_tpu_torch.distributed.fleet.recompute\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')]\n"
        "print(','.join(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"paddle_tpu\."])
def test_no_source_names_jax_or_the_jax_package(pattern):
    rx = re.compile(pattern)
    hits = [f"{f.relative_to(ROOT)}:{i}"
            for f in _port_sources()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if rx.search(line)]
    assert hits == []


@pytest.mark.parametrize("entry", ["model", "stack", "manager", "gpt",
                                   "gpt_moe", "moe_layer"])
def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, entry):
    from paddle_tpu_torch import build_model
    from paddle_tpu_torch.bench import build_moe_model
    from paddle_tpu_torch.incubate.moe import MoELayer
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.inference import (BlockKVCacheManager,
                                            FusedCausalLM)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "model": lambda **kw: FusedCausalLM(32, 16, 2, 32, 1, **kw),
        "stack": lambda **kw: FusedMultiTransformer(16, 2, 32, 1, **kw),
        "manager": lambda **kw: BlockKVCacheManager(1, 2, 8, 4, 8, **kw),
        "gpt": lambda **kw: build_model(16, 1, 2, 128, **kw),
        "gpt_moe": lambda **kw: build_moe_model(16, 1, 2, 128, 2, **kw),
        "moe_layer": lambda **kw: MoELayer(16, num_experts=2, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    make(device="cpu")                      # the explicit request works


def test_cpu_path_builds_nothing(monkeypatch):
    """Plain versions serve CPU tensors without touching nvcc."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.inference import FusedCausalLM, GenerationEngine

    def refuse(*a, **k):
        raise AssertionError("a CUDA kernel was requested on the CPU path")
    monkeypatch.setattr(_kernels, "lib", refuse)
    monkeypatch.setattr(_kernels, "build", refuse)
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl
    from paddle_tpu_torch.serving import ServingEngine, SLOConfig

    from paddle_tpu_torch.nn.functional import grouped_gemm as gg
    from paddle_tpu_torch.nn.functional import lora as tl
    from paddle_tpu_torch.serving import AdapterBank

    before = (pa.launches, sl.launches, sl.tail_launches, fv.launches,
              gg.launches, tl.launches)
    model = FusedCausalLM(32, 16, 2, 32, 1, max_position=32, device="cpu")
    out = GenerationEngine(model, page_size=4, max_length=16).generate(
        [[1, 2, 3]], max_new_tokens=3)
    assert out.shape == (1, 6)
    # the serving frontend's chunked prefill takes the plain version too
    eng = ServingEngine(model, max_batch=2, page_size=4, max_length=24,
                        slo=SLOConfig(prefill_chunk=4))
    eng.submit(list(range(10)), max_new_tokens=3)
    assert [len(r.generated) for r in eng.run()] == [3]
    # an adaptered request and an MoE model take the plain versions too
    bank = AdapterBank.from_stack(model.stack._stack(), slots=1, rank=4)
    bank.load(bank.random_adapter("a0"))
    eng = ServingEngine(model, max_batch=2, page_size=4, max_length=24,
                        slo=SLOConfig(prefill_chunk=4), adapters=bank)
    eng.submit(list(range(10)), max_new_tokens=3, adapter_id="a0")
    assert [len(r.generated) for r in eng.run()] == [3]
    moe = FusedCausalLM(32, 16, 2, 32, 1, max_position=32,
                        moe_num_experts=2, moe_top_k=1, device="cpu")
    out = GenerationEngine(moe, page_size=4, max_length=16).generate(
        [[1, 2, 3]], max_new_tokens=3)
    assert out.shape == (1, 6)
    # a training step takes the plain flash versions too
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.nn.functional import attention as at

    before_at = (at.fwd_launches, at.dq_launches, at.dkv_launches)
    _, step = bench.make_train_step(16, 1, 2, 128, dict(bench._FAST),
                                    device="cpu")
    inputs, labels = bench.rung_batch(1, 128, "cpu")
    assert torch.isfinite(step(inputs, labels))
    assert at.last_attention_backend() == "flash"
    # packed varlen attention takes the plain walks too
    before_fv = (fv.fwd_varlen_launches, fv.dq_varlen_launches,
                 fv.dkv_varlen_launches)
    q = torch.randn(40, 2, 64, requires_grad=True)
    cu = torch.tensor([0, 15, 40], dtype=torch.int32)
    out, _ = at.flash_attn_unpadded(q, q, q, cu, cu, 25, 25, 0.125,
                                    causal=True)
    out.sum().backward()
    assert torch.isfinite(q.grad).all()
    # an MoE training step takes the plain grouped GEMM and dw too
    before_dw = gg.dw_launches
    _, step = bench.make_moe_train_step(16, 1, 2, 64, 2, device="cpu")
    inputs, labels = bench.rung_batch(1, 64, "cpu")
    assert torch.isfinite(step(inputs, labels))
    assert gg.dw_launches == before_dw
    # every decode backend takes its plain version on the CPU
    from paddle_tpu_torch.core.flags import set_flags
    before_pa = (pa.stream_launches, pa.fused_launches, pa.pallas_launches)
    try:
        for value in ("stream", "fused", "pallas", "xla"):
            set_flags({"paged_attention_backend": value})
            if value != "stream":           # head_dim 8: stream raises
                out = GenerationEngine(model, page_size=4,
                                       max_length=16).generate(
                    [[1, 2, 3]], max_new_tokens=2)
                assert out.shape == (1, 5)
            q = torch.randn(1, 2, 128)
            pool = torch.randn(4, 2, 4, 128)
            pa.paged_attention(q, pool, pool, torch.tensor([5]),
                               torch.tensor([[1, 2]]), pool_base=0,
                               pool_pages=4)
    finally:
        set_flags({"paged_attention_backend": "auto"})
    assert (pa.stream_launches, pa.fused_launches,
            pa.pallas_launches) == before_pa
    # the launch counters count CUDA launches only
    assert (pa.launches, sl.launches, sl.tail_launches, fv.launches,
            gg.launches, tl.launches) == before
    assert (at.fwd_launches, at.dq_launches, at.dkv_launches) == before_at
    assert (fv.fwd_varlen_launches, fv.dq_varlen_launches,
            fv.dkv_varlen_launches) == before_fv


def test_kernel_sources_and_wrappers_present():
    """Each ported kernel has its CUDA source, its C entry point and a
    launch counter on its wrapper."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import grouped_gemm as gg
    from paddle_tpu_torch.nn.functional import lora as tl
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    from paddle_tpu_torch.nn.functional import attention as at

    assert set(_kernels._SIGNATURES) == set(_kernels.SOURCES) == {
        "paged_attention", "stream_linear", "flash_varlen",
        "paged_attention_q", "stream_linear_a8w8", "grouped_gemm",
        "flash_attention", "flash_varlen_packed", "paged_backends"}
    for lib, fns in _kernels._SIGNATURES.items():
        src = (PKG / "csrc" / f"{lib}.cu").read_text()
        for fn in fns:
            assert f'extern "C" int {fn}(' in src
        assert "sm_90a" in " ".join(_kernels._FLAGS)
    assert {"ptt_grouped_gemm", "ptt_grouped_dw", "ptt_lora_delta",
            "ptt_grouped_work_map", "ptt_grouped_dw_tiles"} == set(
        _kernels._SIGNATURES["grouped_gemm"])
    assert {"ptt_flash_fwd", "ptt_flash_bwd_dq", "ptt_flash_bwd_dkv"} == \
        set(_kernels._SIGNATURES["flash_attention"])
    assert {"ptt_flash_varlen_fwd", "ptt_flash_varlen_bwd_dq",
            "ptt_flash_varlen_bwd_dkv"} == \
        set(_kernels._SIGNATURES["flash_varlen_packed"])
    assert {"ptt_paged_stream", "ptt_paged_fused", "ptt_paged_pallas"} == \
        set(_kernels._SIGNATURES["paged_backends"])
    for counter in (pa.stream_launches, pa.fused_launches,
                    pa.pallas_launches, pa.launches, pa.q_launches,
                    sl.launches,
                    sl.w8_launches, sl.tail_launches, sl.tail_w8_launches,
                    sl.a8w8_launches, fv.launches, gg.launches,
                    gg.dw_launches, tl.launches, at.fwd_launches,
                    at.dq_launches, at.dkv_launches, fv.fwd_varlen_launches,
                    fv.dq_varlen_launches, fv.dkv_varlen_launches):
        assert isinstance(counter, int)
