"""``paddle_tpu_torch.jit.save`` / ``load`` / ``TranslatedLayer`` against
the JAX package's, on the same numpy weights.

Each model is built in the JAX package from ``seed``, its ``state_dict``
carried into the port's by ``load_jax_params``, and both saved with the
same ``InputSpec``: the JAX round trip of ``TestSaveLoad`` (outputs of
the loaded programs within rtol 1e-5 of each other and of the eager
models; f32 products in another order), a state-only save and the raise
when it is called, a ``None`` dim fixed to 1 with a call at another
shape raising in both packages, a bf16 state that comes back bit for
bit (and equal to the JAX package's saved bf16 state), and ``jit.load``
in a fresh interpreter that imports only ``paddle_tpu_torch.jit``. The
port loads with ``device="cpu"``. Then ``static.InputSpec`` against the
JAX class, and the ``jit`` package's names (``enable_to_static``,
``ignore_module``) against the JAX package's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.static.input_spec import InputSpec as JSpec
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core.place import device_guard
from paddle_tpu_torch.static import InputSpec as TSpec

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with device_guard("cpu"):
        yield


def _carry(jmodel, tmodel):
    load_jax_params(tmodel, {k: np.array(v.numpy())
                             for k, v in jmodel.state_dict().items()})
    return tmodel


def _mlp():
    jp.seed(0)
    j = jnn.Sequential(jnn.Linear(4, 3), jnn.Tanh())
    with torch.device("cpu"):
        t = tnn.Sequential(tnn.Linear(4, 3), tnn.Tanh())
    return j, _carry(j, t)


def _save_both(j, t, tmp_path, spec):
    jpath, tpath = str(tmp_path / "jax" / "m"), str(tmp_path / "port" / "m")
    j.eval()
    t.eval()
    jp.jit.save(j, jpath, input_spec=None if spec is None
                else [JSpec(*spec)])
    tjit.save(t, tpath, input_spec=None if spec is None
              else [TSpec(*spec)])
    return jp.jit.load(jpath), tjit.load(tpath, device="cpu")


def test_roundtrip_matches_jax(tmp_path):
    """The JAX ``TestSaveLoad.test_roundtrip``, in both packages."""
    j, t = _mlp()
    jl, tl = _save_both(j, t, tmp_path, ([1, 4], "float32"))
    x = np.random.RandomState(0).randn(1, 4).astype(np.float32)
    want = j(jp.to_tensor(x)).numpy()
    got = tl(x).numpy()
    np.testing.assert_allclose(got, jl(jp.to_tensor(x)).numpy(), rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(
        got, t(torch.from_numpy(x)).detach().numpy(), rtol=RTOL)
    assert tl.training is False and tl.eval() is tl
    with pytest.raises(RuntimeError, match="inference-only"):
        tl.train()


def test_state_only_save_keeps_the_state_and_refuses_a_call(tmp_path):
    """Without ``input_spec`` only the state is kept (the JAX
    ``test_state_only_save``); calling the loaded layer raises with the
    JAX package's message in both packages."""
    jp.seed(1)
    j = jnn.Linear(2, 2)
    with torch.device("cpu"):
        t = _carry(j, tnn.Linear(2, 2))
    jl, tl = _save_both(j, t, tmp_path, None)
    jsd, tsd = jl.state_dict(), tl.state_dict()
    assert "weight" in tsd and set(tsd) == set(jsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k].numpy(), np.asarray(
            jsd[k].numpy()))
    x = np.ones((1, 2), np.float32)
    for layer, arg in ((jl, jp.to_tensor(x)), (tl, x)):
        with pytest.raises(RuntimeError, match="saved without input_spec"):
            layer(arg)


def test_free_dim_is_fixed_to_one_in_both_packages(tmp_path):
    """``InputSpec([None, 4])``: both programs take ``[1, 4]`` and agree;
    a call with 2 rows raises in both."""
    j, t = _mlp()
    jl, tl = _save_both(j, t, tmp_path, ([None, 4], "float32"))
    x = np.random.RandomState(2).randn(1, 4).astype(np.float32)
    np.testing.assert_allclose(tl(x).numpy(), jl(jp.to_tensor(x)).numpy(),
                               rtol=RTOL)
    x2 = np.zeros((2, 4), np.float32)
    with pytest.raises(Exception):
        jl(jp.to_tensor(x2))
    with pytest.raises(Exception):
        tl(x2)


def test_bf16_state_round_trips_bitwise(tmp_path):
    """A bf16 model's state comes back bit for bit, equal to the bf16
    bits the JAX package saves for the same weights, and the loaded
    program computes what the bf16 model computes, exactly."""
    j, t = _mlp()
    j = j.bfloat16()
    t = t.to(torch.bfloat16)
    jl, tl = _save_both(j, t, tmp_path, ([1, 4], "bfloat16"))
    jsd, tsd = jl.state_dict(), tl.state_dict()
    assert set(jsd) == set(tsd)
    for k, v in t.state_dict().items():
        assert tsd[k].dtype == torch.bfloat16, k
        assert torch.equal(tsd[k].view(torch.int16), v.view(torch.int16)), k
        jbits = np.asarray(jsd[k].numpy()).view(np.int16)
        np.testing.assert_array_equal(tsd[k].view(torch.int16).numpy(),
                                      jbits, err_msg=k)
    x = torch.randn(1, 4, generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    assert torch.equal(tl(x), t(x).detach())


_CHILD = """
import sys
import numpy as np
import torch
import paddle_tpu_torch.jit as jit
layer = jit.load(sys.argv[1], device="cpu")
ids, types = (np.load(sys.argv[2] + n) for n in ("_ids.npy", "_types.npy"))
seq, pooled = layer(ids, types)
np.save(sys.argv[2] + "_seq.npy", seq.numpy())
np.save(sys.argv[2] + "_pooled.npy", pooled.numpy())
bad = [m for m in sys.modules if m == "jax" or m.startswith("paddle_tpu.")]
print("JAX_MODULES", bad)
"""


def test_load_in_a_fresh_interpreter(tmp_path):
    """A small BERT (its attention on B10's op) saved here loads in a new
    interpreter that imports only ``paddle_tpu_torch.jit`` (``load``
    registers the kernels' ops itself) and gives this process's eager
    outputs exactly; nothing of JAX is imported there."""
    from paddle_tpu_torch.text import models as tm

    torch.manual_seed(0)
    with torch.device("cpu"):
        model = tm.bert_tiny(hidden_size=64, num_attention_heads=4,
                             max_position_embeddings=128).eval()
    path = str(tmp_path / "bert")
    tjit.save(model, path, input_spec=[TSpec([2, 128], "int64")] * 2)
    rng = np.random.RandomState(4)
    ids, types = rng.randint(0, 128, (2, 128)), rng.randint(0, 2, (2, 128))
    np.save(path + "_ids.npy", ids)
    np.save(path + "_types.npy", types)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    run = subprocess.run([sys.executable, "-c", _CHILD, path, path],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "JAX_MODULES []" in run.stdout
    with torch.no_grad():
        seq, pooled = model(torch.from_numpy(ids), torch.from_numpy(types))
    np.testing.assert_array_equal(np.load(path + "_seq.npy"), seq.numpy())
    np.testing.assert_array_equal(np.load(path + "_pooled.npy"),
                                  pooled.numpy())


def test_input_spec_matches_jax():
    """``static.InputSpec`` as the JAX class: a ``None`` dim kept as -1,
    ``from_numpy``, ``batch`` and ``unbatch``, the repr; the rest of
    ``static`` raises, naming ROADMAP A12."""
    import paddle_tpu_torch.static as tstatic

    arr = np.zeros((3, 5), np.float32)
    for j, t in ((JSpec([None, 4], "int64", "ids"),
                  TSpec([None, 4], "int64", "ids")),
                 (JSpec.from_numpy(arr, "x"), TSpec.from_numpy(arr, "x")),
                 (JSpec([2, 3]).batch(4), TSpec([2, 3]).batch(4)),
                 (JSpec([4, 2, 3]).unbatch(), TSpec([4, 2, 3]).unbatch())):
        assert t.shape == j.shape and t.name == j.name
        assert t.dtype.name == j.dtype.name
        assert repr(t) == repr(j)
    for name in ("Program", "Executor", "save_inference_model", "nn"):
        with pytest.raises(NotImplementedError, match="A12"):
            getattr(tstatic, name)


def test_jit_names_and_enable_to_static():
    """The JAX ``jit`` package's exports are the port's too;
    ``enable_to_static(False)`` runs a ``to_static`` function eagerly (no
    program captured) until it is switched back on; ``ignore_module`` is
    accepted."""
    from paddle_tpu_torch import jit

    assert set(jp.jit.__all__) <= set(jit.__all__)
    for name in ("enable_to_static", "ignore_module"):
        assert callable(getattr(jit, name))
    assert jit.ignore_module([np]) is None
    fn = jit.to_static(lambda x: x * 2)
    try:
        jit.enable_to_static(False)
        assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))
        assert not fn.program_cache
    finally:
        jit.enable_to_static(True)
    fn(torch.ones(2))
    assert len(fn.program_cache) == 1
