"""Host-side KV page accounting for the paged decode cache.

A copy of ``paddle1_tpu/serving/paging.py`` (host-only code), kept in
the port so that it never imports the JAX package.

The device half of paging is dumb on purpose — per layer, one
``[pages, page_size, heads, dim]`` pool array plus a ``[slots,
max_pages_per_slot]`` int32 page table, both of fixed shape across
decode steps. Everything that must not live on the device lives
here: the free list, per-page refcounts, and the copy-on-write prefix
registry that lets N requests over one system prompt hold its prefill
pages once.

Ground rule that makes sharing exact: K/V at position ``i`` depend only
on ``(token_i, i)`` (causal attention — the projection of token ``i``
at position ``i`` never sees its successors), so a FULL page of a
prompt whose ``(token, position)`` block matches a previously-stored
one is byte-identical and can be aliased by refcount. Partial tail
pages are always private (decode writes into them); the engine never
writes a shared page — a reused page's scatter target is redirected to
the parking page — so no device-side copy-on-write fault path is
needed: the "copy" is simply "the tail page was never shared".

Page 0 is reserved as the **parking page**: free slots' (and beyond-
capacity) decode writes are directed at it so inactive slots can ride
the same dispatch without scatter-colliding into anyone's real pages.
It is never allocated and never read (every reader masks by cursor).

The registry holds one ref per page per entry; a page frees when its
refcount reaches zero (no slot and no cached prefix holds it).
Allocation under pressure LRU-evicts unshared registry entries first
and raises :class:`~paddle1_tpu_torch.serving.errors.KVPoolExhausted` typed
only when the pool is genuinely out of pages.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .errors import KVPageAccountingError, KVPoolExhausted

__all__ = ["PagePool", "PARKING_PAGE"]

PARKING_PAGE = 0


class PagePool:
    """Free list + refcounts + prefix registry over ``num_pages`` KV
    pages of ``page_size`` tokens each. Purely host state — the caller
    (the GenerationEngine, single scheduler thread) owns thread safety.
    """

    def __init__(self, num_pages: int, page_size: int,
                 prefix_entries: int = 0):
        if num_pages < 2:
            raise ValueError(
                f"PagePool needs >= 2 pages (page {PARKING_PAGE} is the "
                f"reserved parking page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_entries = int(prefix_entries)
        self._free: collections.deque = collections.deque(
            range(1, self.num_pages))
        self._refs = np.zeros(self.num_pages, np.int64)
        # key: bytes of the int32 (token) prefix covering n full pages
        # -> tuple of its n page ids; insertion order IS the LRU order
        # (move_to_end on hit).
        self._registry: "collections.OrderedDict[bytes, Tuple[int, ...]]" \
            = collections.OrderedDict()
        # cumulative event counts (the engine mirrors them as metrics)
        self.alloc_count = 0
        self.eviction_count = 0
        self.prefix_hits = 0
        self.prefix_hit_pages = 0

    # -- basic bookkeeping --------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages with any holder (slots or registry), excl. parking."""
        return (self.num_pages - 1) - len(self._free)

    @property
    def registry_pages(self) -> int:
        """Distinct pages held by cached prefixes."""
        return len({p for ids in self._registry.values() for p in ids})

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def alloc(self, n: int) -> List[int]:
        """Claim ``n`` fresh pages (each at refcount 1), LRU-evicting
        cached prefixes under pressure; typed KVPoolExhausted when the
        pool genuinely cannot serve."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        while len(self._free) < n and self._evict_one():
            pass
        if len(self._free) < n:
            raise KVPoolExhausted(
                f"KV page pool exhausted: need {n} page(s), "
                f"{len(self._free)} free of {self.num_pages - 1} "
                f"usable ({self.registry_pages} held by cached "
                "prefixes, none evictable) — raise serve_gen_kv_pages, "
                "lower max_new_tokens/slots, or share more prefix")
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            self._refs[p] += 1
        self.alloc_count += n
        return out

    def retain(self, pages) -> None:
        for p in pages:
            if p == PARKING_PAGE:
                continue
            self._refs[p] += 1

    def release(self, pages) -> None:
        """Drop one ref per page; pages reaching zero return to the
        free list. A release of an already-free page raises typed
        BEFORE mutating anything — appending a page to the free list
        twice would hand it to two holders and silently cross-write
        their KV, which is strictly worse than failing the release."""
        for p in pages:
            if p == PARKING_PAGE:
                continue
            if self._refs[p] <= 0:
                raise KVPageAccountingError(
                    f"KV page {p} over-released (refcount already "
                    f"{int(self._refs[p])}) — slot/registry accounting "
                    "bug; free list left untouched")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def check_invariants(self, holders: Sequence[Sequence[int]] = ()
                         ) -> None:
        """Debug invariant sweep: the sum of refcounts must equal the
        refs actually held by the prefix registry plus every external
        holder chain in ``holders`` (the engine passes its live slots'
        page chains), the free list must be duplicate-free and
        exactly the zero-refcount pages, and the parking page must
        never be tracked. Raises typed KVPageAccountingError."""
        expected = np.zeros(self.num_pages, np.int64)
        for ids in self._registry.values():
            for p in ids:
                expected[p] += 1
        for chain in holders:
            for p in chain:
                if p == PARKING_PAGE:
                    continue
                expected[p] += 1
        free = list(self._free)
        if len(free) != len(set(free)):
            raise KVPageAccountingError(
                "KV free list holds duplicate pages: "
                f"{sorted(p for p in set(free) if free.count(p) > 1)}")
        if PARKING_PAGE in set(free) or self._refs[PARKING_PAGE] != 0:
            raise KVPageAccountingError(
                "parking page leaked into the free list / refcounts")
        free_set = set(free)
        for p in range(1, self.num_pages):
            if int(self._refs[p]) != int(expected[p]):
                raise KVPageAccountingError(
                    f"KV page {p} refcount {int(self._refs[p])} != "
                    f"{int(expected[p])} refs held by registry+holders")
            if (p in free_set) != (self._refs[p] == 0):
                raise KVPageAccountingError(
                    f"KV page {p} refcount {int(self._refs[p])} "
                    f"disagrees with free list membership "
                    f"({'free' if p in free_set else 'not free'})")
        # derived identity the drain report leans on
        if self.pages_in_use != (self.num_pages - 1) - len(free):
            raise KVPageAccountingError(
                f"pages_in_use {self.pages_in_use} != usable - free "
                f"{(self.num_pages - 1) - len(free)}")

    # -- prefix sharing -----------------------------------------------------

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(
            np.asarray(tokens, np.int32)).tobytes()

    def lookup_prefix(self, prompt: np.ndarray) -> List[int]:
        """Longest cached full-page chain matching ``prompt``'s head;
        returns its page ids with one ref RETAINED per page for the
        caller (the slot). Empty list = no hit."""
        if self.prefix_entries <= 0:
            return []
        prompt = np.asarray(prompt, np.int32)
        n_full = len(prompt) // self.page_size
        for n in range(n_full, 0, -1):
            key = self._key(prompt[:n * self.page_size])
            ids = self._registry.get(key)
            if ids is not None:
                self._registry.move_to_end(key)
                self.retain(ids)
                self.prefix_hits += 1
                self.prefix_hit_pages += len(ids)
                return list(ids)
        return []

    def register_prefix(self, prompt: np.ndarray, pages) -> int:
        """Cache every full-page chain of ``prompt`` (lengths 1..n so a
        later SHORTER shared prompt still hits); each entry holds one
        ref per page. Returns entries added. No-op when the registry is
        disabled."""
        if self.prefix_entries <= 0:
            return 0
        prompt = np.asarray(prompt, np.int32)
        pages = list(pages)
        n_full = min(len(prompt) // self.page_size, len(pages))
        added = 0
        for n in range(1, n_full + 1):
            key = self._key(prompt[:n * self.page_size])
            if key in self._registry:
                self._registry.move_to_end(key)
                continue
            ids = tuple(pages[:n])
            self.retain(ids)
            self._registry[key] = ids
            added += 1
        while len(self._registry) > self.prefix_entries:
            if not self._evict_one():
                break
        return added

    def _evict_one(self) -> bool:
        """Drop the least-recently-used registry entry. Eviction only
        removes the registry's own refs, so pages still held by live
        slots (or by longer cached chains) survive; truly idle ones
        return to the free list. Returns False when the registry is
        empty (nothing left to evict)."""
        if not self._registry:
            return False
        _key, ids = self._registry.popitem(last=False)
        self.release(ids)
        self.eviction_count += 1
        return True

    def stats(self) -> Dict[str, int]:
        return {
            "pages_total": self.num_pages - 1,  # usable (excl. parking)
            "pages_free": self.free_pages,
            "pages_in_use": self.pages_in_use,
            "pages_cached": self.registry_pages,
            "prefix_entries": len(self._registry),
            "evictions": self.eviction_count,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_pages": self.prefix_hit_pages,
        }
