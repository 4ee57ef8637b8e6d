"""``paddle_tpu_torch.inference``'s predictor API (``Config``,
``create_predictor``, ``Predictor``, ``PredictorTensor``) against the JAX
package's.

The JAX ``TestPredictorAPI`` flow in both packages on the same numpy
weights (``Linear(8, 4)``, ``InputSpec([2, 8])``): the input and output
names, the outputs within 1e-5 of the JAX predictor's (f32 products in
another order), the raise on an unset input. Then a small BERT (2
layers, d64, 4 heads, 128 tokens: its attention on the flash route)
through both packages' ``jit.save`` -> ``create_predictor``: ``seq`` and
``pooled`` within 1e-5 of the largest value (f32; the JAX attention is
XLA's dense path, the port's B10's plain version, sums in another
order), and the port's exported program calls B10's forward op,
``ptt::flash_fwd``, exactly once a layer (the artifact calls the kernel,
not an inlined plain version). The port runs on the CPU
(``Config.disable_gpu()``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu.static.input_spec import InputSpec as JSpec
from paddle_tpu.text import models as jm
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core.place import device_guard
from paddle_tpu_torch.inference import Config as TConfig
from paddle_tpu_torch.inference import create_predictor as tcreate
from paddle_tpu_torch.static import InputSpec as TSpec
from paddle_tpu_torch.text import models as tm

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with device_guard("cpu"):
        yield


def _carry(jmodel, tmodel):
    load_jax_params(tmodel, {k: np.array(v.numpy())
                             for k, v in jmodel.state_dict().items()})
    return tmodel


def _predictors(j, t, tmp_path, specs):
    jpath, tpath = str(tmp_path / "jax" / "m"), str(tmp_path / "port" / "m")
    j.eval()
    t.eval()
    jp.jit.save(j, jpath, input_spec=[JSpec(*s) for s in specs])
    tjit.save(t, tpath, input_spec=[TSpec(*s) for s in specs])
    config = TConfig(tpath + ".pdmodel")
    config.disable_gpu()
    return jcreate(JConfig(jpath)), tcreate(config)


def _run(predictor, arrays):
    names = predictor.get_input_names()
    for n, a in zip(names, arrays):
        predictor.get_input_handle(n).copy_from_cpu(a)
    assert predictor.run()
    return [predictor.get_output_handle(n).copy_to_cpu()
            for n in predictor.get_output_names()]


def test_save_load_predict_matches_jax(tmp_path):
    """The JAX ``TestPredictorAPI.test_save_load_predict`` flow."""
    jp.seed(0)
    j = jnn.Linear(8, 4)
    with torch.device("cpu"):
        t = _carry(j, tnn.Linear(8, 4))
    jpred, tpred = _predictors(j, t, tmp_path, [([2, 8], "float32")])
    assert tpred.get_input_names() == jpred.get_input_names() == ["input_0"]
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    (got,), (want,) = _run(tpred, [x]), _run(jpred, [x])
    assert tpred.get_output_names() == jpred.get_output_names() \
        == ["output_0"]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, t(torch.from_numpy(x)).detach().numpy(), rtol=TOL, atol=TOL)


def test_unset_input_raises_in_both_packages(tmp_path):
    jp.seed(1)
    j = jnn.Linear(8, 4)
    with torch.device("cpu"):
        t = _carry(j, tnn.Linear(8, 4))
    for pred in _predictors(j, t, tmp_path, [([2, 8], "float32")]):
        with pytest.raises(RuntimeError, match="input 'input_0' was not set"):
            pred.run()


def test_config_surface():
    """The JAX method names; the card unless ``disable_gpu()`` (or
    ``disable_tpu()``); without a card and without that call,
    ``create_predictor`` raises."""
    c = TConfig("model/net.pdmodel")
    assert c.model_path() == "model/net" and c.use_gpu() and c.use_tpu()
    c.enable_bf16()
    c.switch_ir_optim(False)
    c.enable_memory_optim()
    c.set_cpu_math_library_num_threads(2)
    assert "gpu=True" in c.summary() and "bfloat16" in c.summary()
    c.disable_tpu()
    assert not c.use_gpu() and not c.use_tpu()
    c.enable_tpu()
    assert c.use_gpu()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="disable_gpu"):
            tcreate(c)


def test_small_bert_through_both_predictors(tmp_path):
    kw = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=128)
    jp.seed(0)
    j = jm.BertModel(**kw)
    with torch.device("cpu"):
        t = _carry(j, tm.BertModel(**kw))
    spec = ([2, 128], "int64")
    jpred, tpred = _predictors(j, t, tmp_path, [spec, spec])
    rng = np.random.RandomState(5)
    ids, types = rng.randint(0, 128, (2, 128)), rng.randint(0, 2, (2, 128))
    got, want = _run(tpred, [ids, types]), _run(jpred, [ids, types])
    assert tpred.get_output_names() == ["output_0", "output_1"]
    for name, g, w in zip(("seq", "pooled"), got, want):
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= TOL * float(np.abs(w).max()), f"{name}: {err}"
    graph = tpred._layer._module.graph
    targets = [n.target for n in graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.ptt.flash_fwd.default) == 2
    assert not any(str(t).startswith("ptt.") and
                   t != torch.ops.ptt.flash_fwd.default for t in targets)
