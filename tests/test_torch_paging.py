"""The port's copy of the page allocator against the reference's.

One seeded random script of allocations, retains, releases, copy-on-write
forks, prefix-cache inserts and lookups (with evictions when the pool runs
short) runs through ``repro.serving.paging.PageAllocator`` and the port's
``repro_torch.serving.paging.PageAllocator``. Every returned page id, every
refcount, the free list and every counter must be equal after each
operation (integers: exact), and both pass their own invariant check.
"""

import numpy as np
import pytest

from repro.serving.paging import PageAllocator as JPageAllocator
from repro_torch.serving.paging import PageAllocator

COUNTERS = ("hits", "misses", "evictions", "forks", "peak_used", "allocs",
            "releases")


def _state(a):
    return (a.ref.tolist(), list(a._free), list(a._cache.items()),
            a.free_pages, a.used_pages(), a.shared_pages(), a.available(),
            a.cached_pages(), tuple(getattr(a, c) for c in COUNTERS))


def _step(a, rng_state, held, keys):
    """One random operation on allocator ``a``; the choice comes from a
    numpy generator restored to ``rng_state``, so both allocators see the
    same operation. Returns what the operation returned."""
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    op = rng.integers(0, 6)
    try:
        if op == 0:
            got = a.alloc(int(rng.integers(1, 4)))
            held.extend(got)
            return ("alloc", got)
        if op == 1 and held:
            pid = held[int(rng.integers(0, len(held)))]
            a.retain(pid)
            held.append(pid)
            return ("retain", pid)
        if op == 2 and held:
            pid = held.pop(int(rng.integers(0, len(held))))
            a.release(pid)
            return ("release", pid)
        if op == 3 and held:
            shared = [p for p in held if a.ref[p] > 1]
            if shared:
                pid = shared[int(rng.integers(0, len(shared)))]
                new = a.fork(pid)
                held.remove(pid)
                held.append(new)
                return ("fork", pid, new)
        uncached = [p for p in held if p not in a._by_page]
        if op == 4 and uncached:  # the engine publishes a page once
            pid = uncached[int(rng.integers(0, len(uncached)))]
            key = keys[int(rng.integers(0, len(keys)))]
            a.cache_insert(key, pid)
            return ("insert", key, pid)
        if op == 5:
            n = int(rng.integers(1, len(keys) + 1))
            got = a.cache_lookup(keys[:n])
            held.extend(got)
            a.hits += len(got)
            a.misses += int(len(got) < n)
            return ("lookup", got)
    except MemoryError as e:
        return ("oom", str(e))
    return ("noop",)


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("seed,n_pages,page_size", [(0, 6, 4), (1, 12, 16),
                                                    (2, 3, 2), (3, 40, 8)])
def test_scripts_give_equal_ids_and_counters(seed, n_pages, page_size,
                                             prefix_cache):
    rng = np.random.default_rng(seed)
    # cumulative prefix keys, as the engine builds them: page j's key
    # extends page j-1's
    toks = rng.integers(0, 50, 6 * page_size).tolist()
    keys = [tuple(toks[:(j + 1) * page_size]) for j in range(6)]
    ref = JPageAllocator(n_pages, page_size, prefix_cache=prefix_cache)
    port = PageAllocator(n_pages, page_size, prefix_cache=prefix_cache)
    held_ref, held_port = [], []
    for i in range(300):
        state = rng.bit_generator.state
        want = _step(ref, state, held_ref, keys)
        got = _step(port, state, held_port, keys)
        rng.integers(0, 2 ** 31)  # advance the script
        assert got == want, i
        assert _state(port) == _state(ref), i
        port.check()
        ref.check()
    assert port.hits + port.misses + port.forks + port.evictions > 0


def test_null_page_is_pinned_and_misuse_raises():
    a = PageAllocator(2, 4)
    assert a.alloc(2) == [1, 2]
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.release(0)  # the null page: a no-op
    assert a.ref[0] == 1
    with pytest.raises(RuntimeError, match="unshared"):
        a.fork(1)
    a.release(1)
    with pytest.raises(RuntimeError, match="free page"):
        a.release(1)
