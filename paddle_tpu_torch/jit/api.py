"""jit.save / jit.load (counterpart of ``paddle_tpu/jit/api.py``): a
deployable program and its state.

``save`` writes the JAX package's two files:

- ``path + ".pdiparams"``: the state dict (parameters and persistable
  buffers) by ``torch.save``, each tensor on the CPU in its own dtype
  (bf16 bit for bit);
- ``path + ".pdmodel"``: a pickled meta dict whose ``"program"`` is the
  layer's forward exported by ``torch.export`` (non-strict) as a pure
  function of ``(state tensors in meta order, *inputs)`` and serialized
  by ``torch.export.save``, where the JAX package keeps its StableHLO
  blob. The program has one static signature, ``input_spec``'s, with a
  ``-1``/``None`` dim fixed to 1 as the JAX package fixes it; a call at
  another shape raises. The port's kernels are ``torch.library`` ops
  (``ptt::``), so the program calls them by name (B10's forward is
  ``ptt::flash_fwd``) and tracing runs only their fake implementations:
  nothing is launched while saving.

``load`` binds the program to the state read from ``.pdiparams``, which
``TranslatedLayer`` passes at every call, as the JAX class passes its
state to its exported function. It puts the state on the card unless the
caller passes ``device="cpu"``, and imports the modules that register the
kernels' ops itself, so it works in an interpreter that has not.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "TranslatedLayer"]

class _Program(torch.nn.Module):
    """``layer``'s forward as a function of its state and inputs: the
    layer is held outside the module tree, so its state enters the
    exported program as inputs, not as the program's own constants."""

    def __init__(self, layer, names):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        self._names = list(names)

    def forward(self, *flat):
        n = len(self._names)
        out = torch.func.functional_call(
            self._layer, dict(zip(self._names, flat[:n])), tuple(flat[n:]))
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _layer_device(layer) -> torch.device:
    for t in layer.state_dict().values():
        return t.device
    return torch.device("cpu")


def _example(spec, device):
    """A zero tensor of ``spec``'s signature, a free dim fixed to 1."""
    from ..static.input_spec import InputSpec

    if isinstance(spec, torch.Tensor):
        spec = InputSpec.from_tensor(spec)
    shape = tuple(1 if s in (-1, None) else int(s) for s in spec.shape)
    return torch.zeros(shape, dtype=spec.dtype.torch_dtype, device=device)


def save(layer, path, input_spec=None, **configs):
    """Serialize a ``Layer`` for deployment: its state always, and with
    ``input_spec`` (``InputSpec``s or example tensors, one per forward
    input) its forward in eval mode, exported on the layer's device."""
    from ..core.place import device_guard
    from ..nn import Layer
    from .static_function import StaticFunction

    if not isinstance(layer, Layer):
        raise TypeError("jit.save expects a Layer")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = layer.state_dict()
    names = list(state)
    with open(path + ".pdiparams", "wb") as f:
        torch.save({k: v.detach().cpu() for k, v in state.items()}, f)

    program, inputs = None, []
    device = _layer_device(layer)
    if input_spec is not None:
        layer.eval()
        args = [_example(s, device) for s in input_spec]
        inputs = [(list(a.shape), str(a.dtype).rpartition(".")[2])
                  for a in args]
        static = layer.__dict__.get("forward")
        eager = isinstance(static, StaticFunction) and static._enabled
        if eager:       # a to_static layer: export its Python forward
            static._enabled = False
        try:
            with torch.no_grad(), device_guard(device):
                ep = torch.export.export(
                    _Program(layer, names),
                    tuple(t.detach() for t in state.values()) + tuple(args),
                    strict=False)
        finally:
            if eager:
                static._enabled = True
        ep.example_inputs = None    # they hold the state: not saved twice
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        program = buf.getvalue()
    meta = {"class_name": type(layer).__name__, "program": program,
            "device": str(device), "inputs": inputs, "param_names": names}
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f, protocol=4)


class TranslatedLayer:
    """A loaded deployable program (the JAX ``TranslatedLayer``): the
    exported forward bound to its state, inference only."""

    def __init__(self, state, meta, device):
        self._state = state
        self._meta = meta
        self._device = torch.device(device)
        self._flat = [state[k] for k in meta["param_names"]]
        self._module = None
        if meta.get("program") is not None:
            ep = torch.export.load(io.BytesIO(meta["program"]))
            if torch.device(meta["device"]).type != self._device.type:
                from torch.export.passes import move_to_device_pass
                ep = move_to_device_pass(ep, self._device)
            self._module = ep.module()
        self.training = False

    @property
    def input_count(self) -> int:
        """The program's inputs after the state (0 without a program)."""
        return len(self._meta.get("inputs") or ())

    def __call__(self, *args):
        if self._module is None:
            raise RuntimeError(
                "this artifact was saved without input_spec; only "
                "state_dict() is available")
        arrs = [(a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.asarray(a))).to(self._device)
                for a in args]
        with torch.no_grad():
            outs = self._module(*self._flat, *arrs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def state_dict(self):
        return dict(self._state)

    def eval(self):
        self.training = False
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")


def load(path, device=None, **configs):
    """A ``TranslatedLayer`` of ``jit.save``'s two files, its state on
    ``device``: the card unless the caller passes ``"cpu"`` (without a
    card that raises)."""
    from ..core.device import resolve_device
    from ..nn import functional  # noqa: F401  (registers the kernels' ops)

    dev = resolve_device(device)
    with open(path + ".pdiparams", "rb") as f:
        state = torch.load(f, map_location=dev, weights_only=True)
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    return TranslatedLayer(state, meta, dev)
