"""The port's transformer layers against the JAX package's
(``paddle_tpu_torch/nn/layers/transformer.py`` against
``paddle_tpu/nn/layers/transformer.py``).

Each layer is built in both packages, the JAX ``state_dict`` carried
across by ``load_jax_params``, and both fed the same seeded numpy
inputs, in eval mode (no dropout): f32 outputs within 1e-5 and
gradients within 1e-4 of the largest value.

- ``MultiHeadAttention`` with no mask, a bool mask, a 2-D float mask and
  a 4-D float mask, ``need_weights`` (a ``None`` appended), and both
  caches (``Cache``: keys and values concatenated step by step;
  ``StaticCache``: the memory projected once).
- Encoder and decoder layers, post- and pre-norm; the whole
  ``Transformer`` with a causal ``tgt_mask`` and a bool ``src_mask``,
  and its parameters' gradients (the key projections' biases, whose
  gradient is zero in exact arithmetic, within 1e-4 of the largest
  gradient); incremental decoding through
  ``TransformerDecoder.gen_cache``.
- At lengths 128 with no mask the port takes the flash route (B10's
  plain versions on the CPU), asserted by ``last_attention_backend``,
  where the JAX package off the TPU takes its XLA route.
- ``generate_square_subsequent_mask`` (with the whole model); the
  stacks' copies of a layer take fresh parameter names and keep their
  ``ParamAttr`` settings.
- Training dropout draws from the device generator (the same seed, the
  same output; eval untouched), and a 2-D mask reaches the dropout path,
  where the JAX package fails to broadcast it (ROADMAP C6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.core.generator import seed as tseed
from paddle_tpu_torch.nn.functional import attention as tattn

torch.set_num_threads(1)

B, S, E, H, FF = 2, 6, 16, 4, 32


def _pair(make, seed=0):
    """The JAX layer (from ``paddle.seed(seed)``) and the port's with its
    weights, both in eval mode."""
    paddle.seed(seed)
    j = make(jnn)
    t = make(tnn)
    load_jax_params(t, {k: np.array(v.numpy())
                        for k, v in j.state_dict().items()})
    j.eval()
    t.eval()
    return j, t


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.array(want.numpy() if hasattr(want, "numpy") else want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _causal(n):
    return np.triu(np.full((n, n), np.finfo(np.float32).min, np.float32), 1)


def _masks(kind, sq, sk):
    r = np.random.RandomState(3)
    if kind == "none":
        return None
    if kind == "bool":
        m = r.rand(B, 1, sq, sk) > 0.3
        m[..., 0] = True
        return m
    if kind == "float2d":
        return _causal(sq)
    return (r.randn(B, H, sq, sk) * 2).astype(np.float32)


@pytest.mark.parametrize("kind", ["none", "bool", "float2d", "float4d"])
def test_multi_head_attention_matches_jax(kind):
    j, t = _pair(lambda nn: nn.MultiHeadAttention(E, H, kdim=12, vdim=10,
                                                  need_weights=True))
    sk = S if kind == "float2d" else S + 2
    q, k, v = _x(B, S, E), _x(B, sk, 12, seed=2), _x(B, sk, 10, seed=3)
    m = _masks(kind, S, sk)
    jo = j(*(paddle.to_tensor(a) for a in (q, k, v)),
           attn_mask=None if m is None else paddle.to_tensor(m))
    to = t(*(torch.from_numpy(a) for a in (q, k, v)),
           attn_mask=None if m is None else torch.from_numpy(m))
    assert isinstance(to, tuple) and len(to) == 2 and to[1] is None
    assert tattn.last_attention_backend() == "dense"
    _close(to[0], jo[0], 1e-5, f"mha[{kind}]")


def test_multi_head_attention_caches_match_jax():
    j, t = _pair(lambda nn: nn.MultiHeadAttention(E, H))
    mem = _x(B, 5, E, seed=4)
    jc = j.gen_cache(paddle.to_tensor(_x(B, 1, E)))
    tc = t.gen_cache(torch.from_numpy(_x(B, 1, E)))
    assert tuple(tc.k.shape) == (B, 0, H, E // H)
    for step in range(3):
        x = _x(B, 1, E, seed=10 + step)
        jo, jc = j(paddle.to_tensor(x), cache=jc)
        to, tc = t(torch.from_numpy(x), cache=tc)
        _close(to, jo, 1e-5, f"incremental step {step}")
        _close(tc.k, jc.k, 1e-5, "cache k")
    assert tuple(tc.v.shape) == (B, 3, H, E // H)
    js = j.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                     type=jnn.MultiHeadAttention.StaticCache)
    ts = t.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                     type=tnn.MultiHeadAttention.StaticCache)
    x = _x(B, 3, E, seed=20)
    jo, js2 = j(paddle.to_tensor(x), cache=js)
    to, ts2 = t(torch.from_numpy(x), cache=ts)
    assert ts2 is ts
    _close(to, jo, 1e-5, "static cache")


@pytest.mark.parametrize("pre", [False, True])
def test_encoder_layer_matches_jax(pre):
    j, t = _pair(lambda nn: nn.TransformerEncoderLayer(
        E, H, FF, dropout=0.1, activation="gelu", normalize_before=pre))
    x, m = _x(B, S, E), _masks("bool", S, S)
    jo = j(paddle.to_tensor(x), paddle.to_tensor(m))
    to = t(torch.from_numpy(x), torch.from_numpy(m))
    _close(to, jo, 1e-5, f"encoder layer pre={pre}")


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_layer_matches_jax(pre):
    j, t = _pair(lambda nn: nn.TransformerDecoderLayer(
        E, H, FF, normalize_before=pre))
    x, mem = _x(B, S, E), _x(B, S + 3, E, seed=5)
    mm = _masks("float4d", S, S + 3)
    jo = j(paddle.to_tensor(x), paddle.to_tensor(mem),
           paddle.to_tensor(_causal(S)), paddle.to_tensor(mm))
    to = t(torch.from_numpy(x), torch.from_numpy(mem),
           torch.from_numpy(_causal(S)), torch.from_numpy(mm))
    _close(to, jo, 1e-5, f"decoder layer pre={pre}")


@pytest.mark.parametrize("pre", [False, True])
def test_transformer_and_its_gradients_match_jax(pre):
    j, t = _pair(lambda nn: nn.Transformer(E, H, 2, 2, FF,
                                           normalize_before=pre))
    src, tgt = _x(B, S + 2, E), _x(B, S, E, seed=6)
    sm = _masks("bool", S + 2, S + 2)
    jsrc, jtgt = paddle.to_tensor(src), paddle.to_tensor(tgt)
    jsrc.stop_gradient = False
    tsrc = torch.from_numpy(src).requires_grad_()
    tm = tnn.Transformer.generate_square_subsequent_mask(S)
    assert tm.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.array(
        jnn.Transformer.generate_square_subsequent_mask(S).numpy()))
    jo = j(jsrc, jtgt, src_mask=paddle.to_tensor(sm),
           tgt_mask=jnn.Transformer.generate_square_subsequent_mask(S))
    to = t(tsrc, torch.from_numpy(tgt), src_mask=torch.from_numpy(sm),
           tgt_mask=tm)
    _close(to, jo, 1e-5, "transformer")
    # a random projection: sum(out^2) of a layer-normed output is nearly
    # constant, and its gradient rounding noise
    r = _x(B, S, E, seed=9)
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    _close(tsrc.grad, jsrc.grad, 1e-4, "d src")
    jp = dict(j.named_parameters())
    names = [n for n, _ in t.named_parameters()]
    assert names == list(jp)
    top = max(float(p.grad.abs().max()) for p in t.parameters())
    for n, p in t.named_parameters():
        if n.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax ignores a shift of every
            # key's logit): rounding noise in both packages
            assert float(p.grad.abs().max()) <= 1e-4 * top, n
            continue
        _close(p.grad, jp[n].grad, 1e-4, f"grad {n}")


def test_flash_route_at_length_128():
    j, t = _pair(lambda nn: nn.Transformer(32, 4, 1, 1, 64))
    src, tgt = _x(1, 128, 32), _x(1, 128, 32, seed=7)
    jo = j(paddle.to_tensor(src), paddle.to_tensor(tgt))
    tsrc = torch.from_numpy(src).requires_grad_()
    enc = t.encoder(tsrc)
    assert tattn.last_attention_backend() == "flash"
    to = t.decoder(torch.from_numpy(tgt), enc)
    assert tattn.last_attention_backend() == "flash"
    _close(to, jo, 1e-5, "flash route")
    to.sum().backward()
    assert torch.isfinite(tsrc.grad).all()
    # a causal mask sends the decoder's self-attention to the dense route
    t(tsrc, torch.from_numpy(tgt),
      tgt_mask=tnn.Transformer.generate_square_subsequent_mask(128))
    assert tattn.last_attention_backend() == "flash"  # cross-attention last


def test_incremental_decoding_matches_jax():
    j, t = _pair(lambda nn: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(E, H, FF), 2))
    mem = _x(B, 5, E, seed=8)
    jc = j.gen_cache(paddle.to_tensor(mem))
    tc = t.gen_cache(torch.from_numpy(mem))
    steps = []
    for step in range(4):
        x = _x(B, 1, E, seed=30 + step)
        jo, jc = j(paddle.to_tensor(x), paddle.to_tensor(mem), cache=jc)
        to, tc = t(torch.from_numpy(x), torch.from_numpy(mem), cache=tc)
        _close(to, jo, 1e-5, f"decode step {step}")
        steps.append(x)
    # the cached steps equal one causal pass over the same tokens
    full = t(torch.from_numpy(np.concatenate(steps, 1)),
             torch.from_numpy(mem),
             tgt_mask=tnn.Transformer.generate_square_subsequent_mask(4))
    _close(to[:, 0], full[:, -1].detach().numpy(), 1e-5, "cache vs causal")


def test_stack_copies_take_fresh_names_and_keep_attrs():
    from paddle_tpu_torch.regularizer import L2Decay

    attr = tnn.ParamAttr(learning_rate=0.5, regularizer=L2Decay(1e-3))
    t = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, H, FF, weight_attr=attr), 3)
    weights = [p for n, p in t.named_parameters() if n.endswith("weight")
               and "linear" in n]
    names = [p.param_name for p in t.parameters()]
    assert len(names) == len(set(names))
    assert all(p.optimize_attr["learning_rate"] == 0.5
               and isinstance(p.regularizer, L2Decay) for p in weights)
    assert len(weights) == 6
    for a, b in zip(t.layers[0].parameters(), t.layers[2].parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_dropout_draws_from_the_generator_and_takes_a_2d_mask():
    t = tnn.Transformer(E, H, 1, 1, FF, dropout=0.5)
    src, tgt = (torch.from_numpy(_x(B, S, E, seed=s)) for s in (1, 2))
    mask = tnn.Transformer.generate_square_subsequent_mask(S)
    t.eval()
    ref = t(src, tgt, tgt_mask=mask)
    t.train()
    outs = []
    for _ in range(2):
        tseed(11)
        outs.append(t(src, tgt, tgt_mask=mask))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], ref)
    t.eval()
    assert torch.equal(t(src, tgt, tgt_mask=mask), ref)
    # the JAX layer in training fails to broadcast the [s, s] mask on its
    # dropout path (C6); the port broadcasts it over rows and heads
    j = jnn.Transformer(E, H, 1, 1, FF, dropout=0.5)
    j.train()
    with pytest.raises(ValueError, match="broadcast"):
        j(paddle.to_tensor(src.numpy()), paddle.to_tensor(tgt.numpy()),
          tgt_mask=jnn.Transformer.generate_square_subsequent_mask(S))
