"""AMP debugging (counterpart of ``paddle_tpu/amp/debugging.py``).

Operator stats: while collection is on, every functional that passes its
operands through the AMP cast hook (``auto_cast._amp_cast``) counts each
operand's dtype after the cast, keyed ``"{op}<{dtype}>"`` (dtype names
without ``torch.``, as numpy names them), as the JAX package counts
each operand of an eager op. Only those functionals are counted: a torch
op the model calls directly passes no hook.

The tensor checker (``FLAGS_check_nan_inf``) checks the floating
outputs of every torch operator that runs while it is on, through a
``TorchDispatchMode``: a NaN or Inf raises ``FloatingPointError`` (or,
with ``FLAGS_check_nan_inf_level`` > 0, is printed). Each check reads
back to the host; it is a debugging mode.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.flags import define_flag, flag, set_flags

__all__ = ["enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "enable_tensor_checker", "disable_tensor_checker",
           "check_numerics", "TensorCheckerConfig"]

define_flag("check_nan_inf", False,
            "check every operator's floating outputs for NaN/Inf")
define_flag("check_nan_inf_level", 0,
            "0: raise on NaN/Inf; > 0: print and go on")

_op_stats = {"enabled": False, "counts": {}}


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``."""
    return str(dtype).replace("torch.", "")


def enable_operator_stats_collection():
    _op_stats["enabled"] = True
    _op_stats["counts"] = {}


def disable_operator_stats_collection():
    _op_stats["enabled"] = False
    counts = _op_stats["counts"]
    if counts:
        print("<------------------------------------------------------->")
        print("Op list with dtype counts:")
        for k, v in sorted(counts.items()):
            print(f"  {k}: {v}")


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def _record_op(op_name: str, dtype) -> None:
    if _op_stats["enabled"]:
        key = f"{op_name}<{dtype_name(dtype)}>"
        _op_stats["counts"][key] = _op_stats["counts"].get(key, 0) + 1


class TensorCheckerConfig:
    def __init__(self, enable=True, debug_mode=None, output_dir=None,
                 checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


class _NanInfChecker(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(t) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                msg = f"NaN/Inf detected in output of op `{func}`"
                if flag("check_nan_inf_level") == 0:
                    raise FloatingPointError(msg)
                print("[check_nan_inf]", msg)
        return out


_checker = {"mode": None}


def enable_tensor_checker(config: TensorCheckerConfig = None):
    """Turn on ``FLAGS_check_nan_inf`` and check every operator's
    floating outputs from here on, on this thread."""
    if _checker["mode"] is None:
        mode = _NanInfChecker()
        mode.__enter__()
        _checker["mode"] = mode
    set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": False})
    mode, _checker["mode"] = _checker["mode"], None
    if mode is not None:
        mode.__exit__(None, None, None)


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """``(num_nan, num_inf)`` of ``tensor`` as 0-d tensors, printing
    the tensor's stats when either is non-zero."""
    t = torch.as_tensor(tensor)
    num_nan = int(torch.isnan(t).sum())
    num_inf = int(torch.isinf(t).sum())
    if num_nan or num_inf:
        f = t.float()
        stats = {"num_nan": num_nan, "num_inf": num_inf,
                 "min": float(f.min()), "max": float(f.max()),
                 "mean": float(f.mean())}
        print(f"[check_numerics] op={op_type} var={var_name} "
              f"stats={stats}")
    return torch.tensor(num_nan), torch.tensor(num_inf)
