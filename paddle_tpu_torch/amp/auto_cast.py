"""AMP O2 ``decorate`` (counterpart of ``paddle_tpu/amp/auto_cast.py``).

O2 casts every floating parameter of the models to the low-precision
dtype except those of normalization layers, and sets the optimizers'
``_multi_precision`` (f32 master weights) unless ``master_weight`` is
``False``, where a master-free optimizer may write back with
stochastic rounding instead. The O1 per-op lists (``auto_cast``) are not
on the training path of this slice.
"""
from __future__ import annotations

from ..nn.initializer import to_dtype

__all__ = ["decorate", "amp_decorate", "auto_cast"]

_NORM_LAYER_NAMES = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                     "SyncBatchNorm", "RMSNorm")


def _cast_model_to(model, dtype):
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


def auto_cast(*args, **kwargs):
    """O1 autocast lists come with the AMP-O1 slice of the port."""
    raise NotImplementedError(
        "amp.auto_cast (O1 white/black lists) comes with the AMP-O1 "
        "slice of the port")

