"""Prefix/KV-cache reuse: requests sharing a prompt prefix share pages.

Counterpart of ``paddle_tpu/serving/prefix_cache.py``, with the same
blake2b chain keys byte for byte (a prompt maps to the same keys in
both packages).

Serving traffic is dominated by a handful of system prompts; with the
paged pool, reusing their KV is a PAGE-TABLE operation, not a copy
(reference comparator: the block-table indirection of
block_multi_head_attention_kernel.cu — vLLM-style automatic prefix
caching on top of it). Every FULL page of a finished prefill registers
here under the hash CHAIN of its token contents (page p's key folds
page p-1's key, so a match certifies the whole prefix, not one page);
admission maps the longest matching chain into the new sequence via
``BlockKVCacheManager.share`` (+1 refcount per page) and chunk-prefills
only the uncovered suffix.

Correctness rests on two invariants:

- causal KV: page p's K/V depend only on tokens ``0 .. (p+1)*ps-1`` —
  exactly the chain content its key hashes — so equal chains mean
  byte-identical KV;
- copy-on-write sharing: only FULL, immutable prompt pages are ever
  registered; a sharer's decode writes land in its privately owned
  tail pages, and the refcount keeps a shared page alive until its
  LAST user frees (see kv_cache.py).

The KV of a request served through a LoRA adapter depends on the
adapter's weights too, so its chain starts from a ``salt`` naming them
(``AdapterBank.cache_salt``): requests share pages only with requests
of the same adapter (base-model requests: no salt, the keys above).
The JAX package's cache keys on tokens alone and hands one adapter's
pages to another.

The cache itself holds one reference per registered page, so prefixes
outlive their original request; ``evict`` drops LRU entries under pool
pressure (releasing a mid-chain page strands the chain's tail until
LRU collects it too — harmless, just unreachable).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional

import numpy as np

__all__ = ["PrefixCache"]


def _page_key(prev_key: bytes, tokens: np.ndarray) -> bytes:
    """Chain hash of one page's token contents (content-addressed, so
    hash collisions — not python hash(), which is per-process salted —
    would alias DIFFERENT prompts onto one page's KV; blake2b-128
    makes that astronomically unlikely)."""
    h = hashlib.blake2b(prev_key, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class PrefixCache:
    """Hash-chain lookup from prompt prefixes to live pool pages."""

    def __init__(self, mgr, page_size: int,
                 capacity_pages: Optional[int] = None, journal=None):
        self._mgr = mgr
        self.page_size = int(page_size)
        #: max registered pages (None = bounded only by pool pressure
        #: via ``evict``); exceeding it LRU-evicts before insert
        self.capacity_pages = capacity_pages
        #: serving flight recorder (serving/journal.py) or None —
        #: evictions are the pool-pressure signal a post-mortem needs
        #: next to the preempt/requeue events they interleave with
        self._journal = journal
        #: fault-injection registry (serving/faults.py) or None; the
        #: ``prefix.insert`` site fires at the TOP of insert, before
        #: any page ref is taken, so an injected failure never leaks
        #: a retain
        self._faults = None
        #: host-DRAM KV tier, or None — when set, every eviction
        #: funnels through the spill decision point and
        #: ``restore_chain`` pulls spilled continuations back before
        #: admission re-prefills them. The tier comes with the fleet
        #: slice of the port: here it stays None, so eviction releases
        #: pages and ``restore_chain`` returns 0
        self.host_tier = None
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def _chain(self, prompt, n_pages: int, salt: bytes = b""):
        ps = self.page_size
        key = salt
        for p in range(n_pages):
            key = _page_key(key, prompt[p * ps: (p + 1) * ps])
            yield key

    def match(self, prompt, salt: bytes = b"") -> List[int]:
        """Longest cached chain of pages covering ``prompt``'s leading
        tokens, LRU-touched. Capped at ``(len-1)//page_size`` pages so
        at least the final prompt token always prefills — the first
        emitted token needs its freshly computed hidden state. Pure
        lookup: the scheduler owns the hit/miss counters (a request is
        one hit, however many times admission probes it). ``salt``
        names the adapter whose KV the pages hold (b"" = base model)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_pages = max(0, (len(prompt) - 1) // self.page_size)
        pages: List[int] = []
        for key in self._chain(prompt, max_pages, salt):
            page = self._entries.get(key)
            if page is None:
                break
            self._entries.move_to_end(key)
            pages.append(page)
        return pages

    def insert(self, prompt, pages, salt: bytes = b"") -> int:
        """Register a FULLY PREFILLED prompt's full pages (``pages[p]``
        holds tokens ``p*ps..(p+1)*ps-1``; the trailing partial page is
        never registered). Already-cached chain segments dedupe to an
        LRU touch. Returns the number of newly registered pages."""
        f = self._faults
        if f is not None:
            f.fire("prefix.insert")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_full = min(len(pages), len(prompt) // self.page_size)
        added = 0
        for p, key in enumerate(self._chain(prompt, n_full, salt)):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            if self.capacity_pages is not None:
                while len(self._entries) >= self.capacity_pages:
                    if not self.evict(1):
                        return added
            self._mgr.retain([pages[p]])
            self._entries[key] = pages[p]
            added += 1
        return added

    def evict(self, n_entries: int) -> int:
        """Drop up to n LRU entries, releasing the cache's reference
        (a page whose LAST reference this was returns to the free
        list; one still mapped by a live sequence just drops to its
        sharers). Admission calls this under pool pressure. EVERY
        eviction routes through the spill decision point below, so a
        configured host tier turns pool pressure into a demotion
        instead of a recompute — with no tier the decision degrades to
        the plain release this always was."""
        dropped = spilled = 0
        while self._entries and dropped < n_entries:
            key, page = self._entries.popitem(last=False)
            spilled += self._spill_or_release(key, page)
            dropped += 1
        if dropped and self._journal is not None:
            self._journal.record("evict_trigger", -1, -1,
                                 {"pages": dropped, "spilled": spilled})
        return dropped

    def _spill_or_release(self, key: bytes, page: int) -> int:
        """The single evict-vs-spill decision point: copy
        the page's KV to the host tier (content-keyed, so any later
        prompt walking the same chain can restore it), THEN drop the
        cache's reference. The spill happens before the release, so a
        tier rejection (over capacity, tier disabled) leaves exactly
        the old eviction behaviour. Returns 1 if the page spilled."""
        ht = self.host_tier
        spilled = ht.spill(key, page) if ht is not None else 0
        self._mgr.release_pages([page])
        return spilled

    def restore_chain(self, prompt, reserve: int = 1) -> int:
        """Pull ``prompt``'s spilled chain continuation back from the
        host tier into free pool pages — called once per admission
        probe BEFORE ``match``, so restored pages are indistinguishable
        from never-evicted ones. Walks the chain past the cached
        prefix, batches every consecutive host-resident key into one
        allocate+scatter, and registers the pages as ordinary entries.
        ``reserve`` pool pages are left free for the admission's own
        first chunk so a restore can never starve the very request it
        serves. Returns the number of pages restored."""
        ht = self.host_tier
        if ht is None or not len(ht):
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_pages = max(0, (len(prompt) - 1) // self.page_size)
        budget = self._mgr.free_pages - max(int(reserve), 0)
        if self.capacity_pages is not None:
            budget = min(budget,
                         self.capacity_pages - len(self._entries))
        if budget <= 0:
            return 0
        to_restore: List[bytes] = []
        for key in self._chain(prompt, max_pages):
            if key in self._entries:
                continue
            if not ht.has(key) or len(to_restore) >= budget:
                break
            to_restore.append(key)
        if not to_restore:
            return 0
        pages = ht.restore_run(to_restore)
        if pages is None:
            return 0
        for key, page in zip(to_restore, pages):
            # the restore's single page reference transfers to the
            # cache entry — same ownership shape as a fresh insert
            self._entries[key] = page
        return len(pages)

    def clear(self) -> int:
        return self.evict(len(self._entries))
