"""The port's copy of the paged-KV bookkeeping against the JAX package's.

``repro_torch.serve.paging`` is a copy of ``repro.serve.paging`` (the
port may not import it, since ``repro.serve`` imports JAX).  Each
scenario here runs on both copies and must give the same results,
errors included; seeded random alloc/extend/fork/release/evict traces
are replayed through both allocators side by side and must give the
same page ids, refcounts, free lists and prefix entries at every step
(both free lists are deterministic LIFO), with the invariants of the
JAX package's trace interpreter checked after every step: every usable
page free or allocated, each refcount equal to the live references
(slot tables plus prefix entries), the trash page never handed out, and
nothing leaked after a drain.
"""

import numpy as np
import pytest

from repro.serve import paging as jpaging
from repro_torch.serve import paging as tpaging
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

MODS = {"port": tpaging, "jax": jpaging}


def _both(scenario):
    """Run ``scenario(mod)`` on both copies; their transcripts must match."""
    got = {name: scenario(mod) for name, mod in MODS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _outcome(fn):
    """A call's result, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def test_trash_page_and_exports_match():
    assert tpaging.TRASH_PAGE == jpaging.TRASH_PAGE == 0
    assert tpaging.__all__ == jpaging.__all__
    assert issubclass(tpaging.OutOfPages, RuntimeError)
    from repro_torch.serve import OutOfPages, PageAllocator
    assert OutOfPages is tpaging.OutOfPages
    assert PageAllocator is tpaging.PageAllocator


def test_geometry_validates_and_derives():
    def scenario(m):
        out = [_outcome(lambda: m.PageGeometry(*args)) for args in
               ((0, 4, 2), (4, 1, 2), (4, 4, 0), (-1, 4, 2))]
        g = m.PageGeometry(page_size=4, num_pages=9, table_len=8)
        out.append((g.usable_pages, [g.pages_for(n) for n in
                                     (0, 1, 4, 5, 8, 9, 32)]))
        return out

    out = _both(scenario)
    assert [o[0] for o in out[:4]] == ["ValueError"] * 4
    assert out[4] == (8, [0, 1, 1, 2, 2, 3, 8])


def test_alloc_is_atomic_double_free_and_bad_retain_raise():
    def scenario(m):
        a = m.PageAllocator(m.PageGeometry(2, 5, 4))
        out = [a.alloc(2), a.free_count, a.in_use]
        out.append(_outcome(lambda: a.alloc(3)))        # only 2 free
        out.append((a.free_count, a.in_use))            # nothing taken
        out.append(_outcome(lambda: a.alloc(-1)))
        p = out[0][0]
        a.retain(p)
        out.append(a.refcount(p))
        a.release(p)
        a.release(p)
        out.append(_outcome(lambda: a.release(p)))      # double free
        out.append(_outcome(lambda: a.retain(p)))       # freed page
        out.append(_outcome(lambda: a.retain(m.TRASH_PAGE)))
        out.append(_outcome(lambda: a.release(m.TRASH_PAGE)))
        out.append(a.alloc(1))                          # LIFO: p again
        return out

    out = _both(scenario)
    assert out[0] == [1, 2] and out[3][0] == "OutOfPages"
    assert out[4] == (2, 2) and out[5][0] == "ValueError"
    assert out[7][1] == "double free of page 1"
    assert out[-1] == [1]


def test_prefix_cache_longest_match_and_lru():
    def scenario(m):
        a = m.PageAllocator(m.PageGeometry(2, 12, 8))
        c = m.PrefixCache(a)
        pa = a.alloc(3)
        c.publish((1, 2, 3, 4, 5, 6), pa)
        pb = a.alloc(2)
        c.publish((9, 9, 8, 8), pb)
        out = [len(c), sorted(c.pages), a.in_use,
               [a.refcount(p) for p in pa + pb]]
        out.append(c.lookup((1, 2, 3, 4, 7, 7)))         # 2 of 3 pages
        out.append(c.lookup((1, 2, 3, 4, 5, 6, 0)))      # all 3
        out.append(c.lookup((5, 5)))                     # miss
        out.append(c.lookup((1,)))                       # shorter than a page
        c.lookup((9, 9, 8, 8))               # (9,9,8,8) becomes MRU
        # LRU order now: (1,2), (9,9), (1,2,3,4), (1,..,6), (9,9,8,8)
        out.append([c.evict_lru() for _ in range(2)])
        out.append((len(c), c.lookup((9, 9)), c.lookup((1, 2, 0, 0))))
        a.release_all(pa + pb)
        c.clear()
        out.append((len(c), a.in_use, c.evict_lru()))
        return out

    out = _both(scenario)
    assert out[0] == 5 and out[4] == (4, [1, 2]) and out[5] == (6, [1, 2, 3])
    assert out[6] == (0, []) and out[7] == (0, [])
    assert out[9] == (3, (0, []), (0, []))
    assert out[10] == (0, 0, False)


def test_publish_only_full_pages():
    def scenario(m):
        a = m.PageAllocator(m.PageGeometry(4, 8, 4))
        c = m.PrefixCache(a)
        pages = a.alloc(3)
        c.publish(tuple(range(10)), pages)   # 2 full pages, 1 partial
        out = [len(c), sorted(c.pages), [a.refcount(p) for p in pages]]
        c.publish(tuple(range(10)), pages)   # republishing adds nothing
        out.append([a.refcount(p) for p in pages])
        c.publish(tuple(range(3)), a.alloc(1))   # no full page at all
        out.append(len(c))
        return out

    out = _both(scenario)
    assert out[0] == 2 and out[2] == [3, 2, 1] and out[3] == out[2]
    assert out[4] == 2


# ----------------------------------------------------------------------
# seeded traces through both allocators, side by side
# ----------------------------------------------------------------------
class _Side:
    """One allocator + prefix cache driven the way the engine drives them:
    retain before alloc on shared hits, LRU eviction under pressure,
    release-all at retire; ``extend`` grows a live slot by fresh pages
    (decode past its reservation)."""

    def __init__(self, m, num_pages: int):
        self.m = m
        self.geom = m.PageGeometry(page_size=2, num_pages=num_pages,
                                   table_len=8)
        self.alloc = m.PageAllocator(self.geom)
        self.prefix = m.PrefixCache(self.alloc)
        self.slots: dict[int, list[int]] = {}
        self.prompts: dict[int, tuple[int, ...]] = {}
        self.next_slot = 0

    def _take(self, n: int):
        while True:
            try:
                return self.alloc.alloc(n)
            except self.m.OutOfPages:
                if not self.prefix.evict_lru():
                    raise

    def admit(self, prompt, n_pages):
        _, shared = self.prefix.lookup(prompt)
        shared = shared[:n_pages]
        for p in shared:
            self.alloc.retain(p)
        try:
            own = self._take(n_pages - len(shared))
        except self.m.OutOfPages:
            self.alloc.release_all(shared)
            return "requeued"
        pages = shared + own
        self.slots[self.next_slot] = pages
        self.prompts[self.next_slot] = prompt
        self.prefix.publish(prompt, pages)
        self.next_slot += 1
        return pages

    def apply(self, kind, a, b):
        ps = self.geom.page_size
        if kind == "admit":
            # prompt tokens deterministic in (a, b), so prefixes collide
            return self.admit(tuple(range(a, a + b * ps)), b)
        if kind == "fork" and self.slots:
            src = sorted(self.prompts)[a % len(self.prompts)]
            return self.admit(self.prompts[src], len(self.slots[src]))
        if kind == "extend" and self.slots:
            slot = sorted(self.slots)[a % len(self.slots)]
            room = self.geom.table_len - len(self.slots[slot])
            try:
                grown = self._take(min(b, room))
            except self.m.OutOfPages:
                return "full"
            self.slots[slot] += grown
            return grown
        if kind == "release" and self.slots:
            victim = sorted(self.slots)[a % len(self.slots)]
            self.alloc.release_all(self.slots.pop(victim))
            self.prompts.pop(victim)
            return victim
        if kind == "evict":
            return self.prefix.evict_lru()
        return None

    def check(self):
        """The invariants of the JAX package's trace interpreter."""
        g, alloc = self.geom, self.alloc
        assert alloc.in_use + alloc.free_count == g.usable_pages
        refs: dict[int, int] = {}
        for pages in list(self.slots.values()) + list(
                self.prefix._entries.values()):
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        for p in range(1, g.num_pages):
            assert alloc.refcount(p) == refs.get(p, 0), p
        assert self.m.TRASH_PAGE not in refs
        assert alloc.refcount(self.m.TRASH_PAGE) == 0

    def state(self):
        return (list(self.alloc._free), dict(self.alloc._refs),
                list(self.prefix._entries.items()), dict(self.slots))

    def drain(self):
        for pages in self.slots.values():
            self.alloc.release_all(pages)
        self.slots.clear()
        self.prefix.clear()
        self.check()
        assert self.alloc.in_use == 0
        assert self.alloc.free_count == self.geom.usable_pages


@pytest.mark.parametrize("seed", range(12))
def test_seeded_traces_match_side_by_side(seed):
    rng = np.random.default_rng(seed)
    num_pages = int(rng.integers(4, 24))
    sides = [_Side(m, num_pages) for m in MODS.values()]
    kinds = ("admit", "admit", "extend", "fork", "release", "evict")
    for _ in range(80):
        op = (kinds[int(rng.integers(len(kinds)))], int(rng.integers(0, 6)),
              int(rng.integers(1, 5)))
        outs = [side.apply(*op) for side in sides]
        assert outs[0] == outs[1], op
        for side in sides:
            side.check()
        assert sides[0].state() == sides[1].state(), op
    for side in sides:
        side.drain()
