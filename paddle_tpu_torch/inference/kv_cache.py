"""Paged KV-cache block manager for continuous-batching serving.

Counterpart of ``paddle_tpu/inference/kv_cache.py``. Pages are rows of
a preallocated PAGE-MAJOR pool [num_layers * num_pages, n_kv_heads,
page_size, head_dim] on the engine's device; the manager hands out
LOGICAL page ids from a free list so sequences of different lengths
share one pool with no copies. The host accounting (free list order,
refcounts, ownership) is the JAX package's, line for line, so both
packages hand out the same pages for the same calls.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..incubate.nn.fused_transformer import PagedKV

__all__ = ["BlockKVCacheManager"]


class BlockKVCacheManager:
    """Owns the page pool + free list; builds per-batch block tables.

    Pages are REFCOUNTED: ``allocate``/``grow`` hand out pages at
    refcount 1, ``share`` maps existing pages into another sequence at
    +1 (prefix reuse), and ``free`` returns a page to the free list
    only once its last reference drops. Only FULL, immutable prefix
    pages are ever shared, and a sharer's decode writes land in its
    privately owned tail pages.
    """

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 page_size: int = 16, num_pages: int = 512,
                 dtype=torch.float32, reserve_scratch: bool = False,
                 mp_degree: int = 1, mesh=None, device=None):
        if (mp_degree or 1) > 1 or mesh is not None:
            raise NotImplementedError(
                "a kv-head-sharded pool comes with the tensor-parallel "
                "serving slice of the port")
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        if dtype == torch.int8:
            raise NotImplementedError(
                "the int8 KV pool comes with the quantized-serving slice "
                "of the port")
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.num_pages = num_pages
        self.dtype = dtype
        self.device = resolve_device(device)
        # reserve_scratch: page 0 is never handed out, so block-table
        # padding entries (0) and idle continuous-batching slots can
        # write/read it without clobbering a live sequence
        self._free: List[int] = list(
            range(1 if reserve_scratch else 0, num_pages))
        self._owned: dict = {}
        self._refs: Dict[int, int] = {}
        self._faults = None

    def fresh_cache(self) -> PagedKV:
        """A zeroed layer-folded page-major pool on the device."""
        shape = (self.num_layers * self.num_pages, self.num_kv_heads,
                 self.page_size, self.head_dim)
        return PagedKV(
            torch.zeros(shape, dtype=self.dtype, device=self.device),
            torch.zeros(shape, dtype=self.dtype, device=self.device))

    def pages_needed(self, length: int) -> int:
        return -(-length // self.page_size)

    def phys_rows(self, pages: Sequence[int]) -> np.ndarray:
        """Physical pool-row indices of logical ``pages``, layer-major:
        layer l's copy of page p is row ``l * num_pages + p``."""
        pages = np.asarray(list(pages), np.int64)
        layers = np.arange(self.num_layers,
                           dtype=np.int64) * self.num_pages
        return (layers[:, None] + pages[None, :]).reshape(-1)

    def allocate(self, seq_id, max_length: int) -> List[int]:
        """Reserve pages covering max_length tokens for one sequence."""
        n = self.pages_needed(max_length)
        f = self._faults
        if f is not None:
            f.fire("kv.alloc")
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} pages, "
                f"{len(self._free)} free (of {self.num_pages})")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def grow(self, seq_id, n_pages: int) -> List[int]:
        """On-demand paging: extend an existing sequence by n_pages."""
        f = self._faults
        if f is not None:
            f.fire("kv.grow")
        if n_pages > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted growing seq {seq_id}: need "
                f"{n_pages} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = 1
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def free(self, seq_id) -> None:
        self.release_pages(self._owned.pop(seq_id, []))

    def truncate(self, seq_id, new_len: int) -> List[int]:
        """Page-granular rollback: shrink ``seq_id``'s page list to
        ``pages_needed(new_len)`` leading pages, releasing the tail
        (refcount-aware: shared pages stay live). Returns the pages
        released."""
        keep = self.pages_needed(max(int(new_len), 0))
        owned = self._owned.get(seq_id)
        if owned is None or keep >= len(owned):
            return []
        tail = owned[keep:]
        del owned[keep:]
        self.release_pages(tail)
        return tail

    # ---------- refcounting (prefix/KV reuse) ----------

    def retain(self, pages: Sequence[int]) -> None:
        """+1 on live pages."""
        for p in pages:
            if p not in self._refs:
                raise KeyError(f"retain of non-live page {p}")
            self._refs[p] += 1

    def release_pages(self, pages: Sequence[int]) -> None:
        """-1 each; a page returns to the free list when its LAST
        reference drops."""
        for p in pages:
            rc = self._refs.get(p, 0)
            if rc <= 0:
                raise KeyError(f"release of non-live page {p}")
            if rc == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = rc - 1

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def share(self, seq_id, pages: Sequence[int]) -> None:
        """Map already-live pages into ``seq_id``'s page list at +1 ref
        (call BEFORE allocating the sequence's own tail pages)."""
        self.retain(pages)
        self._owned.setdefault(seq_id, []).extend(pages)

    def rekey(self, old_seq_id, new_seq_id) -> None:
        """Move a sequence's page list to a new key."""
        if new_seq_id in self._owned:
            raise KeyError(f"rekey target {new_seq_id!r} already owned")
        if old_seq_id in self._owned:
            self._owned[new_seq_id] = self._owned.pop(old_seq_id)

    def block_tables(self, seq_ids, pages_per_seq: int = None,
                     allow_missing: bool = False):
        """[batch, pages_per_seq] int32 table on the device, padded with
        page 0. ``allow_missing`` maps unknown seq_ids to all-zero
        (scratch) rows — idle continuous-batching slots; otherwise an
        unknown seq_id raises KeyError."""
        if allow_missing:
            rows = [self._owned.get(s, []) for s in seq_ids]
        else:
            rows = [self._owned[s] for s in seq_ids]
        width = pages_per_seq or max(len(r) for r in rows)
        table = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            table[i, : len(r)] = r
        return torch.from_numpy(table).to(self.device)

    @property
    def free_pages(self) -> int:
        return len(self._free)
