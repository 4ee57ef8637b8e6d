"""Automatic mixed precision (counterpart of
``paddle_tpu/amp/auto_cast.py``): O1 ``auto_cast`` and O2 ``decorate``.

O1 casts by Paddle op name, not through ``torch.autocast`` (whose lists
differ and take no custom lists): the port's functionals that the JAX
package dispatches under a listed name (``linear``, ``layer_norm``,
``cross_entropy``, ``scaled_dot_product_attention``, which
``flash_attention`` goes through, and ``flash_attn_unpadded``) pass
their operands through ``_amp_cast(op_name, *tensors)`` first. Under
``auto_cast``, an op in the black list gets its floating operands in
f32; an op in the white list, or any hooked op under O2, in the AMP
dtype; f64 and non-float operands are left alone. The lists are the
JAX package's, copied here, with the custom lists applied as it applies
them. A torch op the model calls directly (``+``, ``reshape``,
``torch.exp``) passes no hook: under O2 the JAX package would cast such
an elementwise op to the AMP dtype too, and the port does not.

O2 ``decorate`` casts every floating parameter of the models to the
low-precision dtype except those of normalization layers, and sets the
optimizers' ``_multi_precision`` (f32 master weights) unless
``master_weight`` is ``False``, where a master-free optimizer may write
back with stochastic rounding instead.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Set

import torch

from .debugging import _op_stats, _record_op

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "white_list", "black_list", "is_auto_cast_enabled",
           "get_amp_dtype", "WHITE_LIST", "BLACK_LIST"]

#: ops that run in the AMP dtype under O1 (matmul-like)
WHITE_LIST: Set[str] = {
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "matmul", "mm", "bmm", "linear", "einsum",
    "scaled_dot_product_attention", "addmm",
}
#: ops that run in f32 under O1 and O2 (reductions, norms, losses)
BLACK_LIST: Set[str] = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "square", "pow",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "kl_div", "bce_with_logits", "binary_cross_entropy",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
    "mean", "sum", "cumsum", "logsumexp", "softmax_with_cross_entropy",
    "erf", "erfinv", "cos_sim", "sigmoid_focal_loss", "normalize",
}

_NORM_LAYER_NAMES = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                     "SyncBatchNorm", "RMSNorm")


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white: Set[str] = set()
        self.custom_black: Set[str] = set()
        # effective lists, computed on entry to auto_cast
        self.eff_white: Set[str] = WHITE_LIST
        self.eff_black: Set[str] = BLACK_LIST

    def recompute(self):
        self.eff_white = (WHITE_LIST | self.custom_white) - self.custom_black
        self.eff_black = (BLACK_LIST | self.custom_black) - self.custom_white


_STATE = _AmpState()


def is_auto_cast_enabled() -> bool:
    return _STATE.enabled


def get_amp_dtype() -> torch.dtype:
    return _STATE.dtype


def white_list() -> Set[str]:
    return _STATE.eff_white


def black_list() -> Set[str]:
    return _STATE.eff_black


def _amp_cast(op_name: str, *tensors):
    """``tensors`` as the op ``op_name`` takes them under the current
    ``auto_cast`` (entries that are not tensors, ``None`` among them,
    pass as they are); each tensor's dtype is also counted while
    operator stats are collected."""
    st = _STATE
    if st.enabled:
        target = None
        if op_name in st.eff_black:
            target = torch.float32
        elif st.level == "O2" or op_name in st.eff_white:
            target = st.dtype
        if target is not None:
            tensors = tuple(
                t.to(target) if torch.is_tensor(t) and t.is_floating_point()
                and t.dtype not in (target, torch.float64) else t
                for t in tensors)
    if _op_stats["enabled"]:
        for t in tensors:
            if torch.is_tensor(t):
                _record_op(op_name, t.dtype)
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Within the block, the hooked ops cast their operands by the lists
    (``level`` "O1" or "O2", ``dtype`` "bfloat16" or "float16"); the
    previous state comes back on exit. Thread-local."""
    prev = (_STATE.enabled, _STATE.dtype, _STATE.level,
            _STATE.custom_white, _STATE.custom_black,
            _STATE.eff_white, _STATE.eff_black)
    _STATE.enabled = bool(enable)
    _STATE.dtype = torch.float16 if str(dtype) in ("float16", "fp16") \
        else torch.bfloat16
    _STATE.level = level
    _STATE.custom_white = set(custom_white_list or ())
    _STATE.custom_black = set(custom_black_list or ())
    _STATE.recompute()
    try:
        yield
    finally:
        (_STATE.enabled, _STATE.dtype, _STATE.level,
         _STATE.custom_white, _STATE.custom_black,
         _STATE.eff_white, _STATE.eff_black) = prev


amp_guard = auto_cast


def _cast_model_to(model, dtype):
    # nn's functionals import this module for their hook
    from ..nn.initializer import to_dtype

    dt = to_dtype(dtype)
    for sub in model.modules():
        if type(sub).__name__.startswith(_NORM_LAYER_NAMES):
            continue
        for p in sub.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dt)
    return model


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters (norm layers excepted) and set
    the optimizers' master weights; returns what it was given, as
    Paddle's ``amp.decorate``."""
    if level not in ("O1", "O2"):
        raise ValueError("level must be O1 or O2")
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            _cast_model_to(m, dtype)
    if optimizers is None:
        return model_list[0] if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for o in opt_list:
        o._multi_precision = master_weight is not False
    if single_model and single_opt:
        return model_list[0], opt_list[0]
    return model_list, opt_list


amp_decorate = decorate
