"""Parity of paddle_tpu_torch's ``cross_entropy`` with paddle_tpu's.

Index labels over the last axis, the JAX package's fast path
(``_fused_index_ce``) on both sides, with the same seeded numpy logits
and labels: labels equal to ``ignore_index`` (zero loss, zero gradient,
out of the mean's denominator) and out-of-range labels (clamped into
``[0, V)``). Tolerances: float32 loss and gradient within 1e-5 of the
largest value (f32 sums in another order); bf16 logits within 1e-2 of
the largest value (both round ``logits - max`` and the gradient to
bf16, in another order of f32 sums: one bf16 ulp). Rows at
``ignore_index`` have a gradient of exactly 0 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import loss as jloss
from paddle_tpu_torch.nn.functional import loss as tloss

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
V = 300


def _case(seed, n=64):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    labels = rng.randint(0, V, n).astype(np.int64)
    labels[::7] = -100                  # ignored
    labels[3] = V + 5                   # clamped to V - 1
    labels[5] = -3                      # clamped to 0
    return logits, labels


def _jax(logits, labels, dtype, reduction):
    x = jnp.asarray(logits).astype(jnp.dtype(dtype))
    lab = jnp.asarray(labels)

    def f(x):
        return jloss._cross_entropy_raw(x, lab, reduction=reduction)
    out, vjp = jax.vjp(f, x)
    (g,) = vjp(jnp.ones_like(out))
    return np.asarray(out, np.float32), np.asarray(g.astype(jnp.float32))


def _port(logits, labels, dtype, reduction):
    x = torch.from_numpy(logits).to(getattr(torch, dtype))
    x.requires_grad_(True)
    out = tloss.cross_entropy(x, torch.from_numpy(labels),
                              reduction=reduction)
    out.backward(torch.ones_like(out))
    assert x.grad.dtype == x.dtype
    return out.detach().float().numpy(), x.grad.float().numpy()


def _close(got, want, tol, what):
    limit = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: {err} > {limit}"


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype, reduction):
    logits, labels = _case(0)
    l_j, g_j = _jax(logits, labels, dtype, reduction)
    l_t, g_t = _port(logits, labels, dtype, reduction)
    assert l_t.shape == l_j.shape
    _close(l_t, l_j, TOL[dtype], "loss")
    _close(g_t, g_j, TOL[dtype], "grad")
    ignored = labels == -100
    assert not g_t[ignored].any() and not g_j[ignored].any()
    if reduction == "none":
        assert not l_t[ignored].any()


def test_chunked_rows_equal_one_pass(monkeypatch):
    """Row chunks (the f32 temporaries' bound) change no bit."""
    logits, labels = _case(1, n=50)
    whole = _port(logits, labels, "bfloat16", "mean")
    monkeypatch.setattr(tloss, "CE_CHUNK_ELEMENTS", 7 * V)
    chunked = _port(logits, labels, "bfloat16", "mean")
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def test_labels_with_the_class_axis_and_all_ignored():
    logits, labels = _case(2, n=8)
    x = torch.from_numpy(logits)
    a = tloss.cross_entropy(x, torch.from_numpy(labels)[:, None])
    b = tloss.cross_entropy(x, torch.from_numpy(labels))
    assert torch.equal(a, b)
    none = tloss.cross_entropy(x, torch.full((8,), -100))
    assert float(none) == 0.0           # the denominator is clamped to 1


def test_unported_options_name_their_slice():
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError, match="losses slice"):
        tloss.cross_entropy(x, torch.zeros(2, 4), soft_label=True)
    with pytest.raises(NotImplementedError, match="losses slice"):
        tloss.cross_entropy(x, torch.zeros(2, dtype=torch.long),
                            label_smoothing=0.1)
