"""AdapterBank: paged multi-LoRA weight banks with hot swap.

Counterpart of ``paddle_tpu/serving/adapters.py``. Tenants share ONE
base weight stream; what differs per tenant is a low-rank delta per
target projection (qkv / out / ffn1 / ffn2).

- **Paged, rank-padded banks.** Per projection the bank holds two
  layer-stacked arrays ``A [L, S, K, R]`` and ``B [L, S, R, N]`` over
  ``S`` fixed SLOTS; an adapter occupies one slot. ``R`` is the rank
  padded to the bank dtype's sublane tile (``nn/functional/lora.py
  pad_rank``); a smaller rank zero-fills the padded columns. The LoRA
  scale ``alpha / rank`` is folded into B at load.
- **Hot load/unload, refcounted.** ``load`` writes a free slot and
  bumps the bank VERSION; ``acquire(name, rid)`` pins an adapter for one
  request and ``release(rid)`` unpins it (idempotent). ``unload`` with
  live references marks the slot DRAINING: new acquires raise
  ``KeyError``, live requests keep their weights, and the slot frees at
  refcount zero.
- **Device operands.** The numpy master copy stays on the host;
  ``operands()`` returns the ``{proj}_a`` / ``{proj}_b`` tensors on the
  bank's device. They are allocated once; a version change copies the
  master into the SAME tensors, so a hot swap changes values only
  (``uploads`` counts the copies).

``random_adapter`` seeds numpy from a CRC32 of ``(name, seed)``, the
same in every process (the JAX package seeds from Python's ``hash``,
which Python salts per process). ``cache_salt(name)`` names an adapter's
weights for the serving prefix cache, whose KV pages depend on them.

Telemetry: ``lora.swaps`` counts completed load/unload events,
``lora.active_adapters`` gauges loaded, non-draining slots.
Tensor-parallel bank layouts come with the TP serving slice.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn.functional.lora import pad_rank
from ..profiler import stats as _stats

__all__ = ["LoRAAdapter", "AdapterBank", "TARGET_PROJECTIONS"]

#: target projections (the stacked base weight each rides on)
TARGET_PROJECTIONS = ("qkv", "out", "ffn1", "ffn2")

#: numpy storage dtype of each bank dtype (bf16 lives as its raw bits)
_HOST = {torch.float32: np.float32, torch.bfloat16: np.int16}


def _to_host(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float values in the bank's host storage (bf16: rounded, as the
    raw 16-bit patterns)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return t.view(torch.int16).numpy() if dtype == torch.bfloat16 \
        else t.numpy()


class LoRAAdapter:
    """One tenant's LoRA weights, host-side.

    ``weights``: dict ``projection -> (A [L, K, r], B [L, r, N])`` over
    any subset of ``TARGET_PROJECTIONS`` (missing projections contribute
    zero delta). ``alpha`` defaults to ``rank`` (scale 1); the ``alpha /
    rank`` scale is folded into B here, once."""

    def __init__(self, name: str, rank: int, weights: Dict[str, tuple],
                 alpha: Optional[float] = None):
        self.name = str(name)
        self.rank = int(rank)
        scale = 1.0 if alpha is None else float(alpha) / self.rank
        self.weights = {}
        for proj, (a, b) in weights.items():
            if proj not in TARGET_PROJECTIONS:
                raise ValueError(
                    f"LoRAAdapter {name!r}: unknown projection "
                    f"{proj!r} (targets: {TARGET_PROJECTIONS})")
            a = np.asarray(a)
            b = np.asarray(b)
            if a.ndim != 3 or b.ndim != 3 or a.shape[-1] != self.rank \
                    or b.shape[1] != self.rank:
                raise ValueError(
                    f"LoRAAdapter {name!r}/{proj}: need A [L, K, r], "
                    f"B [L, r, N] at rank {self.rank}, got "
                    f"{a.shape} / {b.shape}")
            self.weights[proj] = (a, b * scale if scale != 1.0 else b)


class AdapterBank:
    """Paged, refcounted multi-LoRA bank for one model's serving stack.

    ``dims``: dict ``projection -> (K, N)`` (``from_stack`` derives it
    from the stacked weights). ``slots``: bank capacity. ``dtype``: the
    bank's torch dtype (default float32). ``device``: where
    ``operands()`` live — the card unless ``"cpu"`` is asked for."""

    def __init__(self, num_layers: int, dims: Dict[str, tuple], *,
                 slots: int = 8, rank: int = 8, dtype=None, device=None):
        if slots < 1:
            raise ValueError("AdapterBank needs at least one slot")
        self.num_layers = int(num_layers)
        self.slots = int(slots)
        self.rank = int(rank)
        self.dtype = dtype or torch.float32
        if self.dtype not in _HOST:
            raise TypeError(f"AdapterBank: dtype {self.dtype} (float32 or "
                            "bfloat16)")
        self.device = resolve_device(device)
        self.rank_pad = pad_rank(self.rank, self.dtype)
        self.dims = {p: (int(k), int(n)) for p, (k, n) in dims.items()
                     if p in TARGET_PROJECTIONS}
        if not self.dims:
            raise ValueError("AdapterBank: no target projections")
        L, S, R = self.num_layers, self.slots, self.rank_pad
        host = _HOST[self.dtype]
        # host master copy; written in place on load/unload
        self._a = {p: np.zeros((L, S, k, R), host)
                   for p, (k, n) in self.dims.items()}
        self._b = {p: np.zeros((L, S, R, n), host)
                   for p, (k, n) in self.dims.items()}
        self._lock = threading.RLock()
        self._slot_of: Dict[str, int] = {}
        self._free = list(range(self.slots))
        self._refs: Dict[str, int] = {}
        self._draining: Dict[str, bool] = {}
        self._rid_name: Dict[object, str] = {}
        self._loaded_at: Dict[str, int] = {}
        self._version = 0
        self._dev = None            # operand tensors, allocated once
        self._dev_version = -1
        #: host -> device copies of the bank made by ``operands()``
        self.uploads = 0

    # ------------- construction helpers -------------

    @classmethod
    def from_stack(cls, weights: Dict, *, slots: int = 8, rank: int = 8,
                   dtype=None, device=None) -> "AdapterBank":
        """Derive projection dims (and by default the dtype and device)
        from an engine's stacked weights (``qkv_weight [L, d, Nq]``
        etc.; MoE stacks have no ffn1/ffn2 targets). A quantized (int8)
        stack gets float32 adapters."""
        dims = {}
        L = None
        first = None
        for proj in TARGET_PROJECTIONS:
            w = weights.get(f"{proj}_weight")
            if w is None:
                continue
            first = w if first is None else first
            L = int(w.shape[0])
            dims[proj] = (int(w.shape[1]), int(w.shape[2]))
        if L is None:
            raise ValueError(
                "AdapterBank.from_stack: no stacked *_weight entries")
        if dtype is None and first.dtype != torch.int8:
            dtype = first.dtype
        if device is None:
            device = first.device
        return cls(L, dims, slots=slots, rank=rank, dtype=dtype,
                   device=device)

    def random_adapter(self, name: str, rank: Optional[int] = None,
                       seed: int = 0, init_scale: float = 0.02,
                       projections=None) -> LoRAAdapter:
        """A random adapter matching this bank's dims, from a numpy
        generator seeded by a CRC32 of ``(name, seed)`` — the same
        weights in every process."""
        rank = self.rank if rank is None else int(rank)
        if rank > self.rank_pad:
            raise ValueError(
                f"rank {rank} exceeds bank rank_pad {self.rank_pad}")
        rng = np.random.default_rng(
            zlib.crc32(f"{name}\0{int(seed)}".encode()))
        w = {}
        for proj, (k, n) in self.dims.items():
            if projections is not None and proj not in projections:
                continue
            a = rng.standard_normal((self.num_layers, k, rank)) \
                * init_scale
            b = rng.standard_normal((self.num_layers, rank, n)) \
                * init_scale
            w[proj] = (a.astype(np.float32), b.astype(np.float32))
        return LoRAAdapter(name, rank, w)

    # ------------- hot load / unload -------------

    def load(self, adapter: LoRAAdapter) -> int:
        """Write ``adapter`` into a free slot (a version bump, no shape
        change). Returns the slot."""
        with self._lock:
            if adapter.name in self._slot_of:
                raise ValueError(
                    f"adapter {adapter.name!r} is already loaded"
                    + (" (draining)" if self._draining.get(adapter.name)
                       else ""))
            if adapter.rank > self.rank_pad:
                raise ValueError(
                    f"adapter {adapter.name!r} rank {adapter.rank} "
                    f"exceeds bank rank_pad {self.rank_pad}")
            if not self._free:
                pinned = {n: self._refs.get(n, 0)
                          for n in self._slot_of}
                raise RuntimeError(
                    f"AdapterBank full ({self.slots} slots); "
                    f"loaded: {pinned} — unload one first")
            slot = self._free.pop(0)
            for proj in self.dims:
                a_bank = self._a[proj]
                b_bank = self._b[proj]
                a_bank[:, slot] = 0
                b_bank[:, slot] = 0
                if proj in adapter.weights:
                    a, b = adapter.weights[proj]
                    a_bank[:, slot, :, :adapter.rank] = \
                        _to_host(a, self.dtype)
                    b_bank[:, slot, :adapter.rank, :] = \
                        _to_host(b, self.dtype)
            self._slot_of[adapter.name] = slot
            self._refs[adapter.name] = 0
            self._draining[adapter.name] = False
            self._version += 1
            self._loaded_at[adapter.name] = self._version
            _stats.inc("lora.swaps")
            self._publish()
            return slot

    def unload(self, name: str) -> bool:
        """Unload ``name``. With live references the slot DRAINS and
        frees at refcount zero. Returns True when freed now, False when
        draining."""
        with self._lock:
            if name not in self._slot_of:
                raise KeyError(f"adapter {name!r} is not loaded")
            if self._refs.get(name, 0) > 0:
                self._draining[name] = True
                self._publish()
                return False
            self._free_slot(name)
            return True

    def _free_slot(self, name: str) -> None:
        # lock held
        slot = self._slot_of.pop(name)
        for proj in self.dims:
            self._a[proj][:, slot] = 0
            self._b[proj][:, slot] = 0
        self._refs.pop(name, None)
        self._draining.pop(name, None)
        self._loaded_at.pop(name, None)
        self._free.append(slot)
        self._free.sort()
        self._version += 1
        _stats.inc("lora.swaps")
        self._publish()

    # ------------- per-request pinning -------------

    def acquire(self, name: str, rid) -> int:
        """Pin ``name`` for request ``rid``; returns its slot. Raises
        ``KeyError`` for unknown or draining adapters."""
        with self._lock:
            if name not in self._slot_of:
                raise KeyError(f"adapter {name!r} is not loaded")
            if self._draining.get(name):
                raise KeyError(f"adapter {name!r} is draining "
                               "(unload pending)")
            prev = self._rid_name.get(rid)
            if prev == name:
                return self._slot_of[name]
            if prev is not None:
                self._release_name(prev)
            self._rid_name[rid] = name
            self._refs[name] = self._refs.get(name, 0) + 1
            return self._slot_of[name]

    def release(self, rid) -> None:
        """Unpin whatever ``rid`` holds (idempotent)."""
        with self._lock:
            name = self._rid_name.pop(rid, None)
            if name is not None:
                self._release_name(name)

    def _release_name(self, name: str) -> None:
        # lock held
        if name not in self._refs:
            return
        self._refs[name] = max(self._refs[name] - 1, 0)
        if self._refs[name] == 0 and self._draining.get(name):
            self._free_slot(name)

    # ------------- inspection -------------

    def slot_of(self, name: str) -> int:
        with self._lock:
            return self._slot_of[name]

    def refcount(self, name: str) -> int:
        with self._lock:
            return self._refs.get(name, 0)

    def loaded(self):
        """name -> slot of every resident adapter (draining included)."""
        with self._lock:
            return dict(self._slot_of)

    def is_draining(self, name: str) -> bool:
        with self._lock:
            return bool(self._draining.get(name))

    def cache_salt(self, name: str) -> bytes:
        """Names the weights ``name`` holds now (its name and the bank
        version of its load): the prefix-cache chain of an adaptered
        request starts from it, since its KV pages depend on them."""
        with self._lock:
            return f"{name}@{self._loaded_at[name]}".encode()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def _publish(self) -> None:
        # lock held
        active = sum(1 for n in self._slot_of
                     if not self._draining.get(n))
        _stats.set_gauge("lora.active_adapters", active)

    # ------------- device operands -------------

    def operands(self, tp=None) -> Dict[str, torch.Tensor]:
        """``{proj}_a`` / ``{proj}_b`` tensors on the bank's device, in
        its dtype. Allocated on first use; when the version moved since
        the last call the host master is copied into the same tensors
        (``uploads`` counts it). ``tp`` (tensor-parallel layouts) comes
        with the TP serving slice."""
        if tp is not None:
            raise NotImplementedError(
                "AdapterBank.operands(tp=...) (tensor-parallel bank "
                "layouts) comes with the TP serving slice of the port")
        with self._lock:
            if self._dev is not None and self._dev_version == self._version:
                return self._dev
            host = {}
            for proj in self.dims:
                host[f"{proj}_a"] = self._a[proj].copy()
                host[f"{proj}_b"] = self._b[proj].copy()
            version = self._version
            if self._dev is None:
                self._dev = {k: torch.empty(v.shape, dtype=self.dtype,
                                            device=self.device)
                             for k, v in host.items()}
            for k, v in host.items():
                src = torch.from_numpy(v)
                if self.dtype == torch.bfloat16:
                    src = src.view(torch.int16).view(torch.bfloat16)
                self._dev[k].copy_(src)
            self._dev_version = version
            self.uploads += 1
            return self._dev
