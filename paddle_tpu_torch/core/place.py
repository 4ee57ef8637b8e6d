"""Device places (counterpart of ``paddle_tpu/core/place.py``).

A ``Place`` names a device: ``CPUPlace`` the host, ``CUDAPlace`` the
CUDA card (the accelerator place; ``TPUPlace`` is the same class, so
code written against the JAX package runs). ``set_device`` sets the
current place, the one source of truth that ``core.device.
resolve_device(None)`` returns, and with it every entry point and every
tensor-creating op. With nothing set the current place is the card, and
without a card it raises: where the JAX place falls back to the host
when no accelerator is live, the port's does not. ``set_device("cpu")``
is a caller asking for the CPU.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = [
    "Place", "CPUPlace", "CUDAPlace", "TPUPlace", "set_device",
    "get_device", "device_count", "current_place", "is_compiled_with_tpu",
    "is_compiled_with_cuda", "device_guard",
]


class Place:
    """A device: ``(device_type, device_id)``, ``device_type`` ``"cpu"``
    or ``"gpu"``."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    # the JAX package's name for its accelerator place
    is_tpu_place = is_gpu_place


class CPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("cpu", device_id)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


TPUPlace = CUDAPlace

#: the place ``set_device`` set; None: the card
_current_place: Place | None = None


def _card() -> Place:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' (or call set_device('cpu')) to "
            "run the plain PyTorch path on the CPU")
    return CUDAPlace(0)


def current_place() -> Place:
    """The place ``set_device`` set, else the card (raises without
    one)."""
    return _current_place if _current_place is not None else _card()


def set_device(device) -> Place:
    """``set_device("gpu:0")`` (also ``"cuda"``, ``"tpu"``) or
    ``"cpu"``, or a ``Place``: the current place from now on."""
    global _current_place
    if isinstance(device, Place):
        _current_place = device
        return device
    kind, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if kind in ("gpu", "cuda", "tpu"):
        _current_place = CUDAPlace(idx)
    elif kind == "cpu":
        _current_place = CPUPlace(idx)
    else:
        raise ValueError(f"unknown device {device!r}")
    return _current_place


@contextlib.contextmanager
def device_guard(device):
    """The current place is ``device`` (as ``set_device`` takes it, or a
    ``torch.device``) inside the block, and what it was after it."""
    global _current_place
    prev = _current_place
    if isinstance(device, torch.device):
        device = "cpu" if device.type == "cpu" else f"gpu:{device.index or 0}"
    set_device(device)
    try:
        yield _current_place
    finally:
        _current_place = prev


def get_device() -> str:
    """The current place as ``"gpu:0"`` or ``"cpu"``."""
    p = current_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.device_id}"


def device_count() -> int:
    """CUDA cards visible to this process."""
    return torch.cuda.device_count()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None
