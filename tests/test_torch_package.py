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
        "import paddle_tpu_torch.nn.functional.stream_linear\n"
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


@pytest.mark.parametrize("entry", ["model", "stack", "manager"])
def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, entry):
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.inference import (BlockKVCacheManager,
                                            FusedCausalLM)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "model": lambda **kw: FusedCausalLM(32, 16, 2, 32, 1, **kw),
        "stack": lambda **kw: FusedMultiTransformer(16, 2, 32, 1, **kw),
        "manager": lambda **kw: BlockKVCacheManager(1, 2, 8, 4, 8, **kw),
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
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    before = (pa.launches, sl.launches, sl.tail_launches)
    model = FusedCausalLM(32, 16, 2, 32, 1, max_position=32, device="cpu")
    out = GenerationEngine(model, page_size=4, max_length=16).generate(
        [[1, 2, 3]], max_new_tokens=3)
    assert out.shape == (1, 6)
    # the launch counters count CUDA launches only
    assert (pa.launches, sl.launches, sl.tail_launches) == before


def test_kernel_sources_and_wrappers_present():
    """Each ported kernel has its CUDA source, its C entry point and a
    launch counter on its wrapper."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    for lib, fns in _kernels._SIGNATURES.items():
        src = (PKG / "csrc" / f"{lib}.cu").read_text()
        for fn in fns:
            assert f'extern "C" int {fn}(' in src
        assert "sm_90a" in " ".join(_kernels._FLAGS)
    for counter in (pa.launches, sl.launches, sl.tail_launches):
        assert isinstance(counter, int)
