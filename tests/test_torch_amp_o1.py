"""Parity of the port's AMP O1 (``auto_cast``, the op census,
``GradScaler``, ``TrainStep(amp_level=)``) with the JAX package's.

- A tiny GPT (d_model 64, 2 layers, 2 heads, seq 128, the rung's vocab)
  from the root ``bench.build_model`` (JAX) and
  ``paddle_tpu_torch.bench.build_model``, weights carried by
  ``load_jax_params``, trained 3 steps through each ``TrainStep(
  amp_level="O1")`` at bf16 with AdamW under ``LinearWarmup(
  CosineAnnealingDecay)``, no decay on biases and norms, a global-norm
  clip that binds, and an ``L1Decay`` on one weight. Exact: the op
  census of the first step's forward (every hooked op's
  ``"{op}<{dtype}>"`` count). Within tolerances: the losses within
  1e-5 of each other relatively (bf16 products rounded in another
  order; 1.5e-6 measured); the parameters' 3-step updates within 2% of
  the JAX update in relative L2 over all of them (0.6% measured; Adam
  normalises each entry's noise, so a single entry near zero gradient
  says little), and the L1-decayed weight's within 0.1% (its update is
  led by the decay's sign, 3e-5 measured).
- The O2 census of one eager forward, exact as above; and the recorded
  difference: a torch op the model calls directly (``+``, ``F.gelu``)
  passes no hook, so O2 leaves it in f32 where the JAX package casts it.
- ``GradScaler`` over 6 fp16 O1 steps of a tiny MLP with overflows
  injected at steps 2 and 4: the scale and both counters after every
  step equal (exact), the parameters bitwise unchanged across a skipped
  step, and within 1e-5 of the JAX parameters' largest value after the
  run (fp16 products in another order).
- The lists, ``custom_white_list``/``custom_black_list``, the
  tensor checker and ``check_numerics`` against the JAX package's.
- An fp16 operand reaching B10 on the card goes to its launch with the
  fp16 dtype code (a mocked CUDA tensor): no cast around it.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu_torch import _kernels
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.amp.auto_cast import _amp_cast
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep as TTrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402  (the root bench: the JAX rung)

D, L, H, S, B = 64, 2, 2, 128, 2
VOCAB = jbench.VOCAB
STEPS = 3
CLIP = 0.05
#: the functionals the port hooks, by the JAX package's op names
HOOKED = {"linear", "layer_norm", "cross_entropy",
          "scaled_dot_product_attention", "flash_attn_unpadded"}


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (B, S))
    pos = np.tile(np.arange(S), (B, 1))
    labels = rng.randint(0, VOCAB, (B, S))
    return ids, pos, labels


def _models():
    paddle.seed(0)
    jmodel = jbench.build_model(D, L, H, S, remat="none")
    tmodel = tbench.build_model(D, L, H, S, remat="none", device="cpu")
    load_jax_params(tmodel, {n: np.asarray(p._data)
                             for n, p in jmodel.state_dict().items()})
    return jmodel, tmodel


def _no_decay(name):
    return not (name.endswith("bias") or ".ln" in name
                or name.startswith("norm"))


def _sched(lr_mod):
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(1e-3, T_max=4),
                               warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


def _hooked(counts):
    return {k: v for k, v in counts.items() if k.split("<")[0] in HOOKED}


@pytest.fixture(scope="module")
def o1_runs():
    ids, pos, labels = _batch()
    jmodel, tmodel = _models()
    before = {n: p.detach().numpy().copy()
              for n, p in tmodel.named_parameters()}
    jsched, tsched = _sched(paddle.optimizer.lr), _sched(topt.lr)
    jopt = paddle.optimizer.AdamW(
        jsched, parameters=jmodel.parameters(), weight_decay=0.01,
        apply_decay_param_fun=_no_decay,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    to = topt.AdamW(tsched, parameters=tmodel.parameters(),
                    weight_decay=0.01, apply_decay_param_fun=_no_decay,
                    grad_clip=tnn.ClipGradByGlobalNorm(CLIP))
    jmodel.blocks[0].fc1.weight.regularizer = \
        paddle.regularizer.L1Decay(1e-3)
    tmodel.blocks[0].fc1.weight.regularizer = treg.L1Decay(1e-3)

    def jloss(logits, lab):
        return JF.cross_entropy(logits.reshape([-1, VOCAB]),
                                lab.reshape([-1]))

    def tloss(logits, lab):
        return TF.cross_entropy(logits.reshape(-1, VOCAB), lab.reshape(-1))

    jstep = paddle.jit.TrainStep(jmodel, jloss, jopt, amp_level="O1")
    tstep = TTrainStep(tmodel, tloss, to, amp_level="O1")
    # the norm the port's clip meets on its first step
    norms = []
    clip_grads = tstep._clip_grads

    def recording(grads):
        norms.append(float(to._grad_clip.global_norm(grads)))
        return clip_grads(grads)
    tstep._clip_grads = recording
    jin = [paddle.to_tensor(ids), paddle.to_tensor(pos)]
    jlab = [paddle.to_tensor(labels)]
    tin = [torch.from_numpy(ids), torch.from_numpy(pos)]
    tlab = [torch.from_numpy(labels)]
    out = {"jax": {"losses": [], "lrs": []},
           "port": {"losses": [], "lrs": []}}
    for side, step, sched, inp, lab, dbg, opt in (
            ("jax", jstep, jsched, jin, jlab, jdbg, jopt),
            ("port", tstep, tsched, tin, tlab, tdbg, to)):
        for i in range(STEPS):
            if i == 0:
                dbg.enable_operator_stats_collection()
            out[side]["lrs"].append(opt.get_lr())
            out[side]["losses"].append(float(np.asarray(
                step(inp, lab).numpy())))
            if i == 0:
                out[side]["census"] = _hooked(dbg._op_stats["counts"])
                dbg._op_stats["enabled"] = False
            sched.step()
    out["jax"]["params"] = {n: np.asarray(p._data, np.float32)
                            for n, p in jmodel.named_parameters()}
    out["port"]["params"] = {n: p.detach().numpy()
                             for n, p in tmodel.named_parameters()}
    out["before"], out["norms"] = before, norms
    out["models"] = (jmodel, tmodel)
    return out


def test_o1_train_step_census_matches_jax(o1_runs):
    j, t = o1_runs["jax"]["census"], o1_runs["port"]["census"]
    assert t == j
    # the model's structure: 4 linears a block (x, weight, bias) and the
    # bias-free head; 2 LNs a block and the final one; one attention a
    # block; the loss on f32 logits
    assert t["linear<bfloat16>"] == 3 * 4 * L + 2
    assert t["layer_norm<float32>"] == 3 * (2 * L + 1)
    assert t["scaled_dot_product_attention<bfloat16>"] == 3 * L
    assert t["cross_entropy<float32>"] == 1


def test_o1_train_step_follows_jax(o1_runs):
    j, t = o1_runs["jax"], o1_runs["port"]
    assert t["lrs"] == j["lrs"]
    assert len(set(t["lrs"])) == STEPS      # warmup, then decay
    assert o1_runs["norms"][0] > 4 * CLIP   # the clip binds
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    assert t["losses"][-1] < t["losses"][0]
    before = o1_runs["before"]
    num = den = 0.0
    for name, want in j["params"].items():
        dj = want - before[name]
        dt = t["params"][name] - before[name]
        num += float(np.square(dt - dj).sum())
        den += float(np.square(dj).sum())
        if name == "blocks.0.fc1.weight":
            l1 = (float(np.square(dt - dj).sum())
                  / float(np.square(dj).sum())) ** 0.5
    assert (num / den) ** 0.5 <= 2e-2
    assert l1 <= 1e-3


def test_o1_weights_stay_f32_and_listed_ops_cast(o1_runs):
    _, tmodel = o1_runs["models"]
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    x = torch.randn(2, 3)
    with tamp.auto_cast(level="O1"):
        assert TF.linear(x, torch.randn(3, 4)).dtype == torch.bfloat16
        assert TF.layer_norm(x.bfloat16(), 3).dtype == torch.float32
        # f64 and integer operands are left alone, as in the JAX package
        got = _amp_cast("linear", x, x.double(), x.long(), None)
        assert [None if t is None else t.dtype for t in got] == [
            torch.bfloat16, torch.float64, torch.int64, None]
    assert TF.linear(x, torch.randn(3, 4)).dtype == torch.float32


def test_o2_census_and_the_unlisted_op_difference(o1_runs):
    jmodel, tmodel = o1_runs["models"]
    ids, pos, _ = _batch()
    with paddle.amp.auto_cast(level="O2"), jdbg.collect_operator_stats():
        jmodel(paddle.to_tensor(ids), paddle.to_tensor(pos))
        jx = paddle.to_tensor(np.ones((2, 3), np.float32))
        j_add = (jx + jx).dtype
        j_gelu = JF.gelu(jx).dtype
    jc = _hooked(jdbg._op_stats["counts"])
    with tamp.auto_cast(level="O2"), tdbg.collect_operator_stats():
        with torch.no_grad():
            tmodel(torch.from_numpy(ids), torch.from_numpy(pos))
        tx = torch.ones(2, 3)
        t_add = (tx + tx).dtype
        t_gelu = TF.gelu(tx).dtype
    assert _hooked(tdbg._op_stats["counts"]) == jc
    assert jc["linear<bfloat16>"] == 3 * 4 * L + 2
    # the recorded difference: an op outside the hook stays f32 in the
    # port, and the JAX package's O2 casts it
    assert "bfloat16" in str(j_add) and "bfloat16" in str(j_gelu)
    assert t_add == torch.float32 and t_gelu == torch.float32


@pytest.mark.parametrize("custom", [
    {}, {"custom_white_list": ["layer_norm", "softmax"]},
    {"custom_black_list": ["linear", "matmul"]}])
def test_lists_and_custom_lists_match_jax(custom):
    with paddle.amp.auto_cast(**custom):
        jw = set(paddle.amp.white_list())
        jb = set(paddle.amp.black_list())
        assert paddle.amp.is_auto_cast_enabled()
    with tamp.auto_cast(**custom):
        assert tamp.is_auto_cast_enabled()
        assert tamp.get_amp_dtype() == torch.bfloat16
        assert (set(tamp.white_list()), set(tamp.black_list())) == (jw, jb)
        x = torch.randn(2, 3)
        want = torch.float32 if "linear" in jb else torch.bfloat16
        assert TF.linear(x, torch.randn(3, 4)).dtype == want
    assert not tamp.is_auto_cast_enabled()
    with tamp.amp_guard(dtype="float16"):
        assert tamp.get_amp_dtype() == torch.float16


# ---------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------

OVERFLOW_STEPS = (2, 4)


def _mlp_data():
    rng = np.random.RandomState(3)
    w1 = rng.standard_normal((8, 16)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((16, 4)).astype(np.float32) * 0.3
    xs = [rng.standard_normal((5, 8)).astype(np.float32) for _ in range(6)]
    for i in OVERFLOW_STEPS:
        xs[i] = xs[i] * 1e5            # past fp16's 65504 once cast
    ys = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(6)]
    return w1, w2, xs, ys


def _scaler_kw():
    return dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                decr_every_n_nan_or_inf=1)


def _scaler_jax():
    w1, w2, xs, ys = _mlp_data()
    p1, p2 = JParam(jnp.asarray(w1)), JParam(jnp.asarray(w2))
    opt = paddle.optimizer.SGD(0.1, parameters=[p1, p2])
    scaler = paddle.amp.GradScaler(**_scaler_kw())
    rows = []
    for x, y in zip(xs, ys):
        with paddle.amp.auto_cast(level="O1", dtype="float16"):
            h = JF.linear(paddle.to_tensor(x), p1)
            out = JF.linear(h, p2)
        loss = ((out.astype("float32") - paddle.to_tensor(y)) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        rows.append((scaler._scale, scaler._incr_count, scaler._decr_count,
                     [np.asarray(p._data).copy() for p in (p1, p2)]))
    return rows


def _scaler_port():
    w1, w2, xs, ys = _mlp_data()
    p1 = torch.nn.Parameter(torch.from_numpy(w1.copy()))
    p2 = torch.nn.Parameter(torch.from_numpy(w2.copy()))
    opt = topt.SGD(0.1, parameters=[p1, p2])
    scaler = tamp.GradScaler(**_scaler_kw())
    rows = []
    for x, y in zip(xs, ys):
        with tamp.auto_cast(level="O1", dtype="float16"):
            h = TF.linear(torch.from_numpy(x), p1)
            out = TF.linear(h, p2)
        loss = ((out.float() - torch.from_numpy(y)) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        rows.append((scaler._scale, scaler._incr_count, scaler._decr_count,
                     [p.detach().numpy().copy() for p in (p1, p2)]))
    return rows, scaler


def test_grad_scaler_scale_counters_and_skips_match_jax():
    jrows = _scaler_jax()
    trows, scaler = _scaler_port()
    assert [r[:3] for r in trows] == [r[:3] for r in jrows]
    # two overflows halve the scale; two clean steps in a row double it
    assert [r[0] for r in trows] == [2.0 ** 10, 2.0 ** 11, 2.0 ** 10,
                                     2.0 ** 10, 2.0 ** 9, 2.0 ** 9]
    for i in OVERFLOW_STEPS:
        for a, b in zip(trows[i][3], trows[i - 1][3]):
            np.testing.assert_array_equal(a, b)
    for t, j in zip(trows[-1][3], jrows[-1][3]):
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())
    state = scaler.state_dict()
    other = tamp.GradScaler()
    other.load_state_dict(state)
    assert other.state_dict() == state
    assert other.get_init_loss_scaling() == 2.0 ** 9


def test_grad_scaler_unscale_then_clip_and_disabled_passthrough():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(1.0, parameters=[p])
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    scaler.scale((p * torch.tensor([1.0, 2.0, 3.0])).sum()).backward()
    assert torch.equal(p.grad, torch.tensor([8.0, 16.0, 24.0]))
    scaler.unscale_(opt)
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0, 3.0]))
    scaler.minimize(opt, None)           # unscaled once, then stepped
    assert torch.equal(p.detach(), torch.tensor([0.0, -1.0, -2.0]))
    off = tamp.GradScaler(enable=False)
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss and not off.is_enable()


# ---------------------------------------------------------------------
# debugging
# ---------------------------------------------------------------------

def test_check_numerics_and_tensor_checker_match_jax():
    arr = np.array([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
    jn, ji = paddle.amp.debugging.check_numerics(paddle.to_tensor(arr))
    tn, ti = tamp.debugging.check_numerics(torch.from_numpy(arr))
    assert (int(tn), int(ti)) == (int(jn.numpy()), int(ji.numpy())) == (1, 2)
    x = np.array([1.0, 0.0], np.float32)
    jdbg.enable_tensor_checker()
    try:
        with pytest.raises(FloatingPointError):
            paddle.log(paddle.to_tensor(x))
    finally:
        jdbg.disable_tensor_checker()
    tdbg.enable_tensor_checker()
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.from_numpy(x))
        torch.exp(torch.from_numpy(x))   # finite outputs pass
    finally:
        tdbg.disable_tensor_checker()
    torch.log(torch.from_numpy(x))       # and it is off again


# ---------------------------------------------------------------------
# fp16 on the card: B10 takes the fp16 operand, with the fp16 code
# ---------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports the CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_fp16_o1_attention_on_the_card_reaches_b10_with_the_fp16_code(
        monkeypatch):
    """Under O1 at fp16, a CUDA-reporting operand goes to B10's forward
    launch as fp16 (dtype code 3, no cast to bf16 around the kernel), not
    to a plain version; the launch is counted. The library, the stream
    and the output allocation are stand-ins: there is no card here."""
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    launches = []

    class _Lib:
        def ptt_flash_fwd(self, *args):
            launches.append(args)
            return 0

    monkeypatch.setattr(tattn, "flash_attention_fwd_plain", plain)
    monkeypatch.setattr(tattn, "_dense_attention", plain)
    monkeypatch.setattr(_kernels, "lib", lambda name: _Lib())
    monkeypatch.setattr(_kernels, "stream_ptr", lambda device: 0)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    checked = []
    code = _kernels.dtype_code

    def dtype_code(t, what, fp16=False):
        checked.append((t.dtype, fp16))
        return code(t, what, fp16)
    monkeypatch.setattr(_kernels, "dtype_code", dtype_code)
    q = torch.Tensor._make_subclass(_OnCard, torch.randn(1, 128, 2, 64))
    before = tattn.fwd_launches
    with tamp.auto_cast(level="O1", dtype="float16"):
        TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert len(launches) == 1
    assert launches[0][5] == _kernels.FP16_CODE == 3
    assert set(checked) == {(torch.float16, True)}
    assert tattn.fwd_launches == before + 1
