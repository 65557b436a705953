"""Paged KV-cache bookkeeping: page pool geometry, free-list allocator,
refcounted prefix sharing.

The paper's zero-conflict L1 subsystem removes bank conflicts so compute
never stalls on memory; the serving-tier analogue is allocation
granularity.  Instead of billing every slot for a contiguous
``max_len`` stripe, the KV cache lives in a device-resident pool of
fixed-size pages (``page_size`` tokens each) and every slot owns an
int32 *page table* mapping logical page index -> physical page id.
This module is the host-side bookkeeping for that pool:

* :class:`PageGeometry` — the static shape contract (page size, pool
  size, table length).  Page ``0`` is reserved as the *trash page*:
  retired slots' table rows are redirected there on device before their
  pages are recycled, so a stale device table can never alias a page
  that was re-allocated to another request.
* :class:`PageAllocator` — LIFO free-list with per-page refcounts.
  ``alloc`` is atomic (all-or-nothing), ``retain``/``release`` move the
  refcount, and a release of a free page raises instead of corrupting
  the free list (double-free detection).
* :class:`PrefixCache` — token-prefix -> page-id map with LRU eviction.
  Published prefix pages are held alive by the cache's own reference;
  admission hits retain them (copy-on-write sharing: decode only ever
  writes past the shared prefix, so shared pages are never mutated).

Everything here is pure host Python — the device side (pool tensors,
table gathers, trash-row writes) lives in :mod:`repro_torch.serve.engine`
and :mod:`repro_torch.kernels.paged_attention`.  The classes are a
verbatim copy of ``repro.serve.paging`` (the port may not import it:
``repro.serve`` imports JAX); ``tests/test_torch_paging.py`` replays
seeded alloc/extend/fork/release traces through both copies side by
side and holds them to the same page ids, refcounts and free counts,
with no leaked page, no double free, and refcounts equal to the number
of live table references after every step.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PageGeometry", "PageAllocator", "PrefixCache", "OutOfPages"]

#: physical id of the reserved trash page (never allocated, never freed).
TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """The free list cannot satisfy an allocation (even after eviction)."""


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Static geometry of one page pool.

    ``page_size``: tokens per page.  ``num_pages``: physical pages in
    the pool *including* the reserved trash page 0.  ``table_len``:
    logical pages per slot table (``max_len // page_size``).
    """
    page_size: int
    num_pages: int
    table_len: int

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.table_len < 1:
            raise ValueError(f"table_len must be >= 1, got {self.table_len}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved trash "
                f"page), got {self.num_pages}")

    @property
    def usable_pages(self) -> int:
        """Pages available for allocation (pool minus the trash page)."""
        return self.num_pages - 1

    def pages_for(self, n_tokens: int) -> int:
        """Logical pages needed to hold ``n_tokens`` tokens."""
        return -(-n_tokens // self.page_size)


class PageAllocator:
    """Free-list page allocator with per-page refcounts.

    Pages ``1..num_pages-1`` start on the free list (page 0 is the
    trash page and is never handed out).  A page's refcount is the
    number of live references — slot-table entries plus prefix-cache
    publications.  ``pages_in_use + free_count == usable_pages`` is an
    invariant the property tests assert after every trace step.
    """

    def __init__(self, geometry: PageGeometry):
        self.geometry = geometry
        # LIFO free list: recently freed pages are re-used first (warm).
        self._free: list[int] = list(range(geometry.num_pages - 1, TRASH_PAGE, -1))
        self._refs: dict[int, int] = {}

    # -- queries ---------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Number of pages currently allocated (refcount >= 1)."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    # -- lifecycle -------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages from the free list with refcount 1 each.

        Atomic: raises :class:`OutOfPages` without side effects if the
        free list is short.
        """
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, only {len(self._free)} free "
                f"(pool has {self.geometry.usable_pages} usable pages)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, page: int) -> None:
        """Add one reference to an allocated page (prefix sharing)."""
        if page not in self._refs:
            raise ValueError(f"retain of unallocated page {page}")
        self._refs[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference; the page returns to the free list at zero."""
        count = self._refs.get(page, 0)
        if count == 0:
            raise ValueError(f"double free of page {page}")
        if count == 1:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = count - 1

    def release_all(self, pages: list[int]) -> None:
        for p in pages:
            self.release(p)


class PrefixCache:
    """Token-prefix -> shared page ids, with LRU eviction.

    A prefix entry maps the first ``k * page_size`` prompt tokens to the
    ``k`` physical pages holding their KV.  The cache holds its own
    reference on every page it publishes, so entries stay valid while no
    slot uses them; an admission hit calls :meth:`lookup` and *retains*
    the returned pages into the slot's table (the engine does the
    retain).  ``evict_lru`` releases the cache's references so the
    allocator can recycle cold prefixes under pressure.

    Only full pages are shareable: decode and partial-page prefill
    write *past* the prefix, never into it, which is what makes the
    sharing copy-on-write by construction.
    """

    def __init__(self, allocator: PageAllocator):
        self._alloc = allocator
        # insertion order == LRU order (moved-to-end on hit)
        self._entries: dict[tuple[int, ...], list[int]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> set[int]:
        """All page ids currently published (for invariant checks)."""
        out: set[int] = set()
        for pages in self._entries.values():
            out.update(pages)
        return out

    def lookup(self, prompt: tuple[int, ...]) -> tuple[int, list[int]]:
        """Longest published prefix of ``prompt``.

        Returns ``(n_tokens_covered, page_ids)`` — ``(0, [])`` on miss.
        The caller must ``retain`` each returned page before using it.
        """
        ps = self._alloc.geometry.page_size
        best: tuple[int, ...] | None = None
        for k in range(len(prompt) // ps, 0, -1):
            key = tuple(prompt[: k * ps])
            if key in self._entries:
                best = key
                break
        if best is None:
            return 0, []
        pages = self._entries.pop(best)
        self._entries[best] = pages          # move to MRU position
        return len(best), list(pages)

    def publish(self, prompt: tuple[int, ...], pages: list[int]) -> None:
        """Publish every full-page prefix of ``prompt`` backed by ``pages``.

        ``pages`` are the slot's physical pages in logical order; entry
        ``k`` (for each ``k`` in ``1..n_full``) references the first
        ``k`` of them.  The cache retains each referenced page once per
        entry, so eviction of one entry never invalidates another.
        """
        ps = self._alloc.geometry.page_size
        n_full = min(len(prompt) // ps, len(pages))
        for k in range(1, n_full + 1):
            key = tuple(prompt[: k * ps])
            if key in self._entries:
                continue
            entry = list(pages[:k])
            for p in entry:
                self._alloc.retain(p)
            self._entries[key] = entry

    def evict_lru(self) -> bool:
        """Release the least-recently-used entry; False if empty."""
        if not self._entries:
            return False
        key = next(iter(self._entries))
        pages = self._entries.pop(key)
        self._alloc.release_all(pages)
        return True

    def clear(self) -> None:
        while self.evict_lru():
            pass
