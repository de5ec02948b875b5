"""Paged KV memory: a refcounted block-pool allocator (vLLM-style).

The pool divides a fixed KV budget into ``page_size``-token pages and
hands them out by id; *what* a page id indexes is the owner's business —
:class:`~repro.serving.realengine.RealBackend` points ids into physical
``(num_pages, page_size, heads, head_dim)`` JAX arrays, while the
control plane uses the same arithmetic (``pages_for``/``padded``) for
fragmentation-aware capacity accounting without ever touching a pool.

Sharing is reference counting: a page referenced by N holders (in-flight
requests, radix prefix-cache nodes) is freed only when the last holder
releases it, which is what makes prefix-cache hits zero-copy — a new
request increfs the shared prefix pages into its block table instead of
recomputing (or copying) their KV.  Pages are immutable while shared:
writers must go through :meth:`KVPool.cow`, which returns the same page
when exclusively owned and a fresh page (caller copies the payload) when
shared.  Because prefix sharing is page-aligned — only whole pages enter
the radix cache, and a request's fresh tokens always start on a fresh
page — the serving paths never actually trigger a copy; ``cow`` exists
so that invariant is checkable rather than assumed.

Every transition enforces pool invariants (no double free, no foreign
ids, refcounts never negative) with **real exceptions** — a double free
or a foreign page id raises :class:`PageStateError` even under
``python -O`` (``assert`` statements vanish there, and these checks are
load-bearing: a silent double free corrupts another request's KV) — and
:meth:`KVPool.assert_empty` gives tests a leak check; stats (peak usage,
max refcount observed, CoW copies) are the observability surface the
acceptance tests read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Sequence


class PageAllocError(RuntimeError):
    """The pool cannot satisfy an allocation (capacity, not a bug)."""


class PageStateError(RuntimeError):
    """A page-lifecycle invariant was violated (always a bookkeeping
    bug): double free, incref/cow of a free page, a foreign page id, a
    leaked page at drain, or a corrupt free list.  Deliberately not an
    ``AssertionError`` so ``python -O`` cannot strip the check —
    ``tools/check_opt_invariants.py`` proves this in CI."""


@dataclass
class PoolStats:
    """Counters the pool keeps for observability/tests."""

    allocs: int = 0  # pages handed out by alloc()
    frees: int = 0  # pages returned to the free list
    cow_copies: int = 0  # cow() calls that had to break sharing
    peak_in_use: int = 0
    max_refcount: int = 0  # highest refcount ever observed (>1 == sharing)


class KVPool:
    """Fixed-size page pool with refcounted pages.

    ``page_size`` is in tokens; ids run ``0..num_pages-1``.  The pool
    never touches tensors — owners map ids onto storage.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"KVPool needs positive sizes, got num_pages={num_pages} "
                f"page_size={page_size}"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._ref = [0] * self.num_pages
        # LIFO free list: recently-freed pages are re-used first (their
        # physical pages are most likely still warm in HBM row buffers)
        self._free: List[int] = list(range(self.num_pages))[::-1]
        self.stats = PoolStats()

    # -- arithmetic (shared with the pool-less control plane) --------------
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (ceil)."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def padded(self, n_tokens: int) -> int:
        """``n_tokens`` rounded up to a whole-page token count — the
        fragmentation-aware footprint of a ``n_tokens``-long sequence."""
        return self.pages_for(n_tokens) * self.page_size

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages currently referenced more than once (prefix sharing)."""
        return sum(1 for r in self._ref if r > 1)

    # -- allocate / retain / release ---------------------------------------
    def alloc(self, n: int) -> List[int]:
        """``n`` fresh pages at refcount 1.  All-or-nothing: raises
        :class:`PageAllocError` (allocating nothing) when short."""
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            raise PageAllocError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free "
                f"of {self.num_pages} (page_size={self.page_size})"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            if self._ref[p] != 0:
                raise PageStateError(f"free-list page {p} had refs")
            self._ref[p] = 1
        self.stats.allocs += n
        self._note_usage()
        return out

    def incref(self, pages: Iterable[int]) -> None:
        """Retain already-live pages (a new holder of a shared prefix)."""
        for p in pages:
            self._check_id(p)
            if self._ref[p] <= 0:
                raise PageStateError(f"incref of free page {p}")
            self._ref[p] += 1
            if self._ref[p] > self.stats.max_refcount:
                self.stats.max_refcount = self._ref[p]

    def decref(self, pages: Iterable[int]) -> None:
        """Release one reference per page; refcount 0 frees the page.
        Double frees raise :class:`PageStateError` — they are always a
        bookkeeping bug."""
        for p in pages:
            self._check_id(p)
            if self._ref[p] <= 0:
                raise PageStateError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                self.stats.frees += 1

    def cow(self, page: int) -> tuple:
        """Copy-on-write: make ``page`` exclusively writable.

        Returns ``(page_id, needs_copy)``.  Exclusively-owned pages come
        back unchanged (``needs_copy=False``); shared pages release one
        reference and return a fresh page the caller must copy the
        payload into (``needs_copy=True``).
        """
        self._check_id(page)
        if self._ref[page] <= 0:
            raise PageStateError(f"cow of free page {page}")
        if self._ref[page] == 1:
            return page, False
        fresh = self.alloc(1)[0]
        self._ref[page] -= 1  # shared ⇒ never drops to 0 here
        self.stats.cow_copies += 1
        return fresh, True

    def refcount(self, page: int) -> int:
        self._check_id(page)
        return self._ref[page]

    # -- invariants --------------------------------------------------------
    def assert_empty(self) -> None:
        """Leak check: every page back in the free list (raises
        :class:`PageStateError`, not AssertionError — ``-O``-proof)."""
        leaked = [p for p, r in enumerate(self._ref) if r > 0]
        if leaked:
            raise PageStateError(
                f"leaked pages (refcount > 0): {leaked[:16]}"
            )
        if len(self._free) != self.num_pages:
            raise PageStateError(
                f"free list holds {len(self._free)} of {self.num_pages} "
                "pages with no refs outstanding (corrupt free list)"
            )

    def _check_id(self, p: int) -> None:
        if not 0 <= p < self.num_pages:
            raise PageStateError(f"foreign page id {p}")

    def _note_usage(self) -> None:
        if self.in_use > self.stats.peak_in_use:
            self.stats.peak_in_use = self.in_use


@dataclass
class BlockTable:
    """One request's page mapping: token position ``i`` lives in
    ``pages[i // page_size]`` at offset ``i % page_size``."""

    pool: KVPool
    pages: List[int] = field(default_factory=list)
    num_tokens: int = 0

    def adopt(self, pages: Sequence[int], n_tokens: int) -> None:
        """Take over already-retained pages (prefix hit / migration);
        the caller has arranged the references, the table tracks them."""
        if self.pages:
            raise PageStateError("adopt into a non-empty table")
        if len(pages) != self.pool.pages_for(n_tokens):
            raise PageStateError(
                f"adopt of {len(pages)} pages for {n_tokens} tokens "
                f"(page_size={self.pool.page_size})"
            )
        self.pages = list(pages)
        self.num_tokens = n_tokens

    def ensure(self, n_tokens: int) -> List[int]:
        """Grow the table to cover ``n_tokens``; returns the pages newly
        allocated (empty when the tail page still has room)."""
        need = self.pool.pages_for(n_tokens)
        fresh: List[int] = []
        if need > len(self.pages):
            fresh = self.pool.alloc(need - len(self.pages))
            self.pages.extend(fresh)
        self.num_tokens = max(self.num_tokens, n_tokens)
        return fresh

    def shrink(self, n_tokens: int) -> List[int]:
        """Page-exact rollback: drop the tail pages not needed to cover
        ``n_tokens`` and return them (already decref'd — freed unless
        someone else still holds them).  Speculative decoding uses this
        to discard the KV of rejected draft tokens; rejected offsets
        *inside* the kept tail page are left as-is — attention masks by
        length and the next accepted tokens overwrite them.

        Only ever sheds pages the speculation itself appended (fresh,
        refcount-1 tail pages past the prompt), so shared radix-prefix
        pages are untouchable by construction.
        """
        keep = self.pool.pages_for(n_tokens)
        if keep > len(self.pages):
            raise PageStateError(
                f"shrink to {n_tokens} tokens needs {keep} pages but the "
                f"table holds {len(self.pages)}"
            )
        tail = self.pages[keep:]
        if tail:
            self.pool.decref(tail)
            del self.pages[keep:]
        self.num_tokens = n_tokens
        return tail

    def release(self) -> None:
        """Drop every reference this table holds (request leaves)."""
        self.pool.decref(self.pages)
        self.pages = []
        self.num_tokens = 0
