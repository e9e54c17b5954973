"""Host-side physical page accounting for the paged KV cache (a copy of
the reference's numpy-only ``serving/paging.py``, so the port imports no
module of the reference).

The device holds one physical page pool shared by every slot
(``pages_*`` leaves, see ``models.attention.paged_cache_init``); this
module owns which physical page backs which logical page, entirely in
numpy on the host — allocation never touches the device.

Three ideas, one invariant:

* **Refcounts.** Every physical page has a count of table entries that
  point at it, plus one for a prefix-cache hold. A page returns to the
  free list exactly when its count hits zero. Physical page 0 is the
  reserved *null page* (pos ≡ -1 on device, never written); its count is
  pinned so it can never be allocated or freed.
* **Copy-on-write.** A page with refcount > 1 is shared and must never
  be written. The engine calls :meth:`fork` before dispatching a write
  that lands on a shared page: the writer gets a fresh physical id, the
  old id loses one reference, and the device copies the payload
  (``ServingEngine._page_maintenance``). Readers keep bit-identical
  history; the writer diverges privately.
* **Prefix cache.** Fully-written prompt pages are published under their
  *exact* token-tuple key (no hashing — a hash collision would silently
  splice one prompt's KV into another and break determinism). The cache
  holds one reference per entry; entries whose only reference is the
  cache's (refcount == 1) are evictable, LRU-first, when allocation
  would otherwise fail.

Invariant: ``free + Σ(ref > 0)`` partitions the pool — every page is
either on the free list with ref 0, or off it with ref > 0.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["PageAllocator", "PageCacheKey"]

# A prefix-cache key: the exact prompt tokens the page holds, i.e.
# tuple(prompt[: (j + 1) * page_size]) for logical page j. Keys are
# cumulative, so page j's key is a strict extension of page j-1's —
# consecutive-hit lookup walks them in order and stops at the first miss.
PageCacheKey = Tuple[int, ...]


class PageAllocator:
    """Refcounted free-list allocator with LRU prefix-cache eviction.

    Physical ids run 1..n_pages; id 0 is the null page and is never
    handed out. All methods are host-side and O(pages touched).
    """

    def __init__(self, n_pages: int, page_size: int, *,
                 prefix_cache: bool = True):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.prefix_cache_enabled = bool(prefix_cache)
        # pop() takes from the tail: keep low ids first-out for
        # reproducible layouts run-to-run.
        self._free: List[int] = list(range(self.n_pages, 0, -1))
        self.ref = np.zeros(self.n_pages + 1, np.int32)
        self.ref[0] = 1  # null page: pinned, never allocated
        # key -> physical id; insertion order is LRU order (move_to_end
        # on touch), so eviction pops from the front.
        self._cache: "OrderedDict[PageCacheKey, int]" = OrderedDict()
        self._by_page: Dict[int, PageCacheKey] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.forks = 0
        self.peak_used = 0
        # churn totals (monotone): pages taken by alloc() / references
        # dropped by release() — the per-step difference is the page-pool
        # churn metric the observability registry exports
        self.allocs = 0
        self.releases = 0

    # -- gauges ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def shared_pages(self) -> int:
        """Pages referenced more than once (COW-protected)."""
        return int((self.ref[1:] > 1).sum())

    def available(self) -> int:
        """Pages obtainable right now: free ∪ evictable cache entries."""
        evictable = sum(1 for pid in self._cache.values()
                        if self.ref[pid] == 1)
        return len(self._free) + evictable

    # -- allocation --------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (ref = 1 each), evicting cache-only
        entries LRU-first if the free list runs short. All-or-nothing:
        raises MemoryError and restores prior state if ``n`` can't be met
        (evicted cache *entries* are not restored — only page ownership)."""
        got: List[int] = []
        while len(got) < n:
            if not self._free and not self._evict_one():
                for pid in got:  # roll back
                    self.ref[pid] = 0
                    self._free.append(pid)
                raise MemoryError(
                    f"out of KV pages: need {n}, had {len(got)} "
                    f"(pool {self.n_pages}, used {self.used_pages()})")
            pid = self._free.pop()
            self.ref[pid] = 1
            got.append(pid)
        self.allocs += len(got)
        self.peak_used = max(self.peak_used, self.used_pages())
        return got

    def retain(self, pid: int) -> None:
        if pid == 0:
            return  # null page holds are meaningless
        if self.ref[pid] <= 0:
            raise RuntimeError(f"retain of free page {pid}")
        self.ref[pid] += 1

    def release(self, pid: int) -> None:
        if pid == 0:
            return
        if self.ref[pid] <= 0:
            raise RuntimeError(f"release of free page {pid}")
        self.releases += 1
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            # a cached page's cache hold is one of its refs, so reaching
            # zero means it was already evicted (or never cached).
            self._free.append(pid)

    def fork(self, pid: int) -> int:
        """COW: give the caller a private copy-target for shared ``pid``.

        Drops the caller's reference on ``pid`` and returns a fresh page;
        the device-side payload copy is the engine's job."""
        if self.ref[pid] <= 1:
            raise RuntimeError(f"fork of unshared page {pid} "
                               f"(ref {int(self.ref[pid])})")
        new = self.alloc(1)[0]
        self.release(pid)
        self.forks += 1
        return new

    # -- prefix cache ------------------------------------------------------

    def cache_lookup(self, keys: Sequence[PageCacheKey]) -> List[int]:
        """Longest consecutive run of cached pages for ``keys`` (the
        per-page cumulative keys of one prompt, in order). Each returned
        page is retained for the caller. Counters (``hits``/``misses``) are
        the caller's to update — a lookup may be rolled back (admission
        plan aborted for lack of pages), and only committed plans should
        count."""
        out: List[int] = []
        if not self.prefix_cache_enabled:
            return out
        for key in keys:
            pid = self._cache.get(key)
            if pid is None:
                break
            self._cache.move_to_end(key)
            self.retain(pid)
            out.append(pid)
        return out

    def cache_insert(self, key: PageCacheKey, pid: int) -> None:
        """Publish ``pid`` (which the caller owns) under ``key``. The
        cache takes its own reference; duplicate keys just refresh LRU."""
        if not self.prefix_cache_enabled:
            return
        if key in self._cache:
            self._cache.move_to_end(key)
            return
        self.retain(pid)
        self._cache[key] = pid
        self._by_page[pid] = key

    def cached_pages(self) -> int:
        return len(self._cache)

    def _evict_one(self) -> bool:
        """Drop the LRU cache entry whose page nothing else holds."""
        for key, pid in self._cache.items():
            if self.ref[pid] == 1:
                del self._cache[key]
                del self._by_page[pid]
                self.release(pid)
                self.evictions += 1
                return True
        return False

    # -- invariants (tests) -------------------------------------------------

    def check(self) -> None:
        assert self.ref[0] == 1, "null page ref must stay pinned"
        free = set(self._free)
        assert len(free) == len(self._free), "free list has duplicates"
        for pid in range(1, self.n_pages + 1):
            on_free = pid in free
            assert on_free == (self.ref[pid] == 0), (
                f"page {pid}: ref {int(self.ref[pid])}, free={on_free}")
        for key, pid in self._cache.items():
            assert self.ref[pid] >= 1 and self._by_page[pid] == key
