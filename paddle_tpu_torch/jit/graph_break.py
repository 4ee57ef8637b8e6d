"""Graph-break diagnostics of ``to_static`` (counterpart of
``paddle_tpu/jit/graph_break.py``).

The JAX package traces a ``to_static`` function once with abstract
values, so a data-dependent Python branch surfaces as a JAX
concretization error mid-trace, which it re-raises as
``GraphBreakError``. The port runs a program's first call under
``GraphBreakCheck``, a ``TorchDispatchMode`` that raises the same error
at the first operation a captured program could not replay: a read of a
tensor's value on the host (``aten._local_scalar_dense``, which
``bool(t)``, ``int(t)``, ``float(t)`` and ``t.item()`` reach) or an
operation whose output shape depends on the data (``nonzero``,
``masked_select``, ``unique``, indexing by a boolean mask). It names the function and the user's
frame, on the CPU and on the card alike, before anything is captured.
"""
from __future__ import annotations

import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["GraphBreakError", "GraphBreakCheck"]

_aten = torch.ops.aten
#: host reads of a tensor's value
_HOST_READS = {_aten._local_scalar_dense.default}
#: operations whose output shape depends on the data, by packet name
_DATA_SHAPED = ("nonzero", "masked_select", "_unique", "_unique2",
                "unique_dim", "unique_consecutive")

_INTERNAL = (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             os.path.dirname(os.path.abspath(torch.__file__)))


class GraphBreakError(RuntimeError):
    """Data-dependent Python control flow (or an eager-only op) inside a
    ``to_static`` program."""


def _user_frame() -> str:
    """The deepest frame of the current stack outside torch and this
    package: the user's ``if tensor:`` line."""
    for fr in reversed(traceback.extract_stack()):
        f = os.path.abspath(fr.filename)
        if not f.startswith(_INTERNAL) and "<frozen" not in fr.filename:
            return f"{fr.filename}:{fr.lineno} ({fr.line})"
    return "<unknown frame>"


def _error(fn_name: str, op: str) -> GraphBreakError:
    eager_op = next((n for n in ("nonzero", "masked_select", "unique")
                     if n in op), None)
    hints = [
        f"graph break while tracing `{fn_name}`: the Python code makes "
        f"a data-dependent decision on a traced Tensor at {_user_frame()}.",
        "Under @to_static the function is captured once per input "
        "signature and replayed, so `if tensor:`, `while tensor:`, "
        "`int(tensor)` or `tensor.item()` cannot run in it.",
        "Fixes: use torch.where/masking for data-dependent selection, or "
        "move the branch out of the traced function.",
    ]
    if eager_op:
        hints.append(
            f"Note: `{eager_op}` has a data-dependent output shape and is "
            "eager-only; inside traced code use where/masking with a "
            "static bound instead.")
    hints.append(f"--- operation ---\n{op}")
    return GraphBreakError("\n".join(hints))


class GraphBreakCheck(TorchDispatchMode):
    """Raise ``GraphBreakError`` for ``fn_name`` at a host read or a
    data-shaped operation; every other operation runs as it is."""

    def __init__(self, fn_name: str):
        super().__init__()
        self.fn_name = fn_name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _HOST_READS or \
                func.overloadpacket.__name__ in _DATA_SHAPED or \
                (func is _aten.index.Tensor and any(
                    i is not None and i.dtype == torch.bool
                    for i in args[1])):
            raise _error(self.fn_name, str(func))
        return func(*args, **(kwargs or {}))
