"""Radix-tree prefix cache over prompt token ids (SGLang-style).

Multi-turn and agentic traffic re-sends the conversation so far on every
turn; the KV for that shared prefix is identical across turns (and across
requests sharing a system prompt), so a prefill instance that kept it can
skip recomputing it.  The cache is a radix tree: each edge holds a run of
token ids, each node the virtual-clock time of its last use.  Lookups
return the longest cached prefix; inserts splice new suffixes in,
splitting edges at divergence points; eviction trims least-recently-used
leaves until the token footprint fits the budget.

The tree stores *token counts*, not real KV tensors — the serving
simulator prices the skipped work through
:meth:`~repro.core.hwmodel.HardwareModel.prefill_chunk_iter`'s
``n_ctx`` argument, and :class:`~repro.serving.realengine.RealBackend`
still runs the full real forward (token content must not depend on cache
state).  A lookup never matches the *entire* query: the last prompt token
must always be computed, because its logits produce the first output
token.

Locked tokens: a prefix a request is actively prefilling against cannot
be evicted mid-flight; engines pin the path via :meth:`RadixCache.lock`
at enqueue and release the returned handle when the request leaves
prefill (completion or failure).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class RadixNode:
    """One edge+node: ``tokens`` is the edge label from the parent."""

    tokens: Tuple[int, ...]
    parent: Optional["RadixNode"] = None
    children: Dict[int, "RadixNode"] = field(default_factory=dict)
    last_access: float = 0.0
    locks: int = 0  # in-flight prefills pinned on this path
    # KV pool page ids backing this edge's tokens (PagedRadixCache only;
    # the cache holds one pool reference per attached page)
    pages: List[int] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children


def _common_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixCache:
    """Prefix cache of one prefill instance, capacity in tokens."""

    def __init__(self, capacity_tokens: int = 1 << 60):
        self.capacity_tokens = int(capacity_tokens)
        self.root = RadixNode(tokens=())
        self.size_tokens = 0
        # observability
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evicted_tokens = 0

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    def _walk(self, tokens: Sequence[int]) -> Tuple[RadixNode, int]:
        """Deepest node on ``tokens``' path and the matched length."""
        node, matched = self.root, 0
        while matched < len(tokens):
            child = node.children.get(tokens[matched])
            if child is None:
                break
            k = _common_len(child.tokens, tokens[matched:])
            matched += k
            if k < len(child.tokens):
                break
            node = child
        return node, matched

    def _cap(self, matched: int, n: int) -> int:
        """Usable match length: the last prompt token always computes
        (its logits are the first output).  Paged subclasses also
        quantize to whole pages here."""
        return min(matched, n - 1)

    def match_len(self, tokens: Optional[Sequence[int]]) -> int:
        """Longest cached prefix of ``tokens`` — pure peek, no touch.

        Capped at ``len(tokens) - 1``: a full match still computes the
        final token (its logits are the first output).
        """
        if not tokens:
            return 0
        _, matched = self._walk(tokens)
        return self._cap(matched, len(tokens))

    def lookup(self, tokens: Optional[Sequence[int]], now: float) -> int:
        """Longest cached prefix; touches the path's recency."""
        if not tokens:
            return 0
        node, matched = self._walk(tokens)
        matched = self._cap(matched, len(tokens))
        self.lookup_tokens += len(tokens)
        self.hit_tokens += matched
        while node is not None:
            node.last_access = now
            node = node.parent
        return matched

    def lock(self, tokens: Optional[Sequence[int]]) -> Optional[RadixNode]:
        """Pin the current match path of ``tokens``; returns the handle to
        pass to :meth:`unlock`.  The handle pins the exact nodes matched
        *now* — a later insert of the same tokens must not let another
        request's unlock strip this pin (re-walking by tokens would)."""
        if not tokens:
            return None
        node, _ = self._walk(tokens)
        n = node
        while n is not None:
            n.locks += 1
            n = n.parent
        return node

    def unlock(self, handle: Optional[RadixNode]) -> None:
        """Release the pin taken by :meth:`lock`.  Edge splits preserve
        the handle's ancestor chain (the split copies the lower node's
        lock count to the inserted upper node), so decrementing from the
        handle upward always releases exactly the pinned nodes."""
        node = handle
        while node is not None:
            node.locks = max(0, node.locks - 1)
            node = node.parent

    # ------------------------------------------------------------------
    # Insert / evict
    # ------------------------------------------------------------------
    def insert(self, tokens: Optional[Sequence[int]], now: float) -> int:
        """Add ``tokens``' full path; returns newly cached token count."""
        if not tokens:
            return 0
        node, pos = self.root, 0
        added = 0
        tokens = tuple(tokens)
        while pos < len(tokens):
            child = node.children.get(tokens[pos])
            if child is None:
                leaf = RadixNode(tokens[pos:], parent=node, last_access=now)
                node.children[tokens[pos]] = leaf
                added += len(leaf.tokens)
                node = leaf
                break
            k = _common_len(child.tokens, tokens[pos:])
            if k < len(child.tokens):
                # split the edge at the divergence point
                child = self._split(child, k)
            node, pos = child, pos + k
            node.last_access = now
        self.size_tokens += added
        self._evict_to_fit()
        return added

    def _split(self, node: RadixNode, k: int) -> RadixNode:
        """Split ``node``'s edge after ``k`` tokens; returns the new
        upper node (same subtree semantics, no size change)."""
        parent = node.parent
        upper = RadixNode(
            node.tokens[:k], parent=parent,
            last_access=node.last_access, locks=node.locks,
        )
        lower_tokens = node.tokens[k:]
        node.tokens = lower_tokens
        node.parent = upper
        upper.children[lower_tokens[0]] = node
        parent.children[upper.tokens[0]] = upper
        return upper

    def _evict_to_fit(self) -> None:
        """Trim LRU leaves until the footprint fits.  One DFS collects
        every evictable leaf into a heap; parents that *become* leaves
        re-enter it — O(n log n) per over-capacity insert rather than a
        whole-tree rescan per evicted leaf."""
        if self.size_tokens <= self.capacity_tokens:
            return
        heap: List[Tuple[float, int, RadixNode]] = []
        stack: List[RadixNode] = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and n.is_leaf and n.locks == 0:
                heapq.heappush(heap, (n.last_access, id(n), n))
        while self.size_tokens > self.capacity_tokens and heap:
            _, _, leaf = heapq.heappop(heap)
            parent = leaf.parent
            self._remove_leaf(leaf)
            if parent is not self.root and parent.is_leaf \
                    and parent.locks == 0:
                heapq.heappush(heap, (parent.last_access, id(parent), parent))

    def _remove_leaf(self, leaf: RadixNode) -> None:
        self.size_tokens -= len(leaf.tokens)
        self.evicted_tokens += len(leaf.tokens)
        del leaf.parent.children[leaf.tokens[0]]

    # ------------------------------------------------------------------
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from cache."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    def reset_stats(self) -> None:
        self.hit_tokens = self.lookup_tokens = self.evicted_tokens = 0


# ---------------------------------------------------------------------------
# Page-granular radix cache (paged KV pool)
# ---------------------------------------------------------------------------


class PagedRadixCache(RadixCache):
    """Radix prefix cache whose unit of sharing is a whole KV **page**.

    Every edge spans a multiple of ``page_size`` tokens and children are
    keyed by the edge's *first page* (two prompts diverging mid-page
    share nothing — their page contents differ, so their KV pages can't
    be shared either).  Matches, inserts and splits all quantize to page
    boundaries, which keeps the control plane's ``cached_len`` exactly
    equal to what a paged real backend can reuse.

    With a :class:`~repro.serving.kvpool.KVPool` bound (``pool``), nodes
    additionally hold the page ids backing their tokens
    (:meth:`attach_pages` / :meth:`match_pages`): a prefix hit hands the
    hitting request the *same physical pages* — zero-copy reuse — and
    eviction releases the cache's references back to the pool.  Without
    a pool (the simulator) the cache is pure accounting, bit-identical
    in match lengths and eviction order, which is what keeps Sim/Real
    backend parity through the paged path.
    """

    def __init__(self, capacity_tokens: int = 1 << 60,
                 page_size: int = 16, pool=None):
        super().__init__(capacity_tokens)
        assert page_size > 0
        self.page_size = int(page_size)
        self.pool = pool  # KVPool (real backend) or None (simulation)

    # -- page arithmetic ----------------------------------------------------
    def _quant(self, n: int) -> int:
        return (n // self.page_size) * self.page_size

    def _cap(self, matched: int, n: int) -> int:
        return self._quant(min(matched, n - 1))

    def _key(self, tokens: Sequence[int]) -> Tuple[int, ...]:
        """Child key: the edge's first page."""
        return tuple(tokens[: self.page_size])

    def _common_pages(self, a: Sequence[int], b: Sequence[int]) -> int:
        """Longest common prefix in whole pages (token count)."""
        ps = self.page_size
        n = min(len(a), len(b)) // ps
        i = 0
        while i < n and tuple(a[i * ps:(i + 1) * ps]) \
                == tuple(b[i * ps:(i + 1) * ps]):
            i += 1
        return i * ps

    # -- overridden tree navigation ----------------------------------------
    def _walk(self, tokens: Sequence[int]) -> Tuple[RadixNode, int]:
        tokens = tuple(tokens)
        node, matched = self.root, 0
        while matched + self.page_size <= len(tokens):
            child = node.children.get(self._key(tokens[matched:]))
            if child is None:
                break
            k = self._common_pages(child.tokens, tokens[matched:])
            matched += k
            if k < len(child.tokens):
                break
            node = child
        return node, matched

    def insert(self, tokens: Optional[Sequence[int]], now: float) -> int:
        """Add ``tokens``' whole-page prefix (the sub-page tail is never
        shareable, so it is never cached)."""
        if not tokens:
            return 0
        tokens = tuple(tokens[: self._quant(len(tokens))])
        if not tokens:
            return 0
        node, pos = self.root, 0
        added = 0
        while pos < len(tokens):
            child = node.children.get(self._key(tokens[pos:]))
            if child is None:
                leaf = RadixNode(tokens[pos:], parent=node, last_access=now)
                node.children[self._key(tokens[pos:])] = leaf
                added += len(leaf.tokens)
                node = leaf
                break
            k = self._common_pages(child.tokens, tokens[pos:])
            if k < len(child.tokens):
                child = self._split(child, k)
            node, pos = child, pos + k
            node.last_access = now
        self.size_tokens += added
        self._evict_to_fit()
        return added

    def _split(self, node: RadixNode, k: int) -> RadixNode:
        assert k % self.page_size == 0, (k, self.page_size)
        parent = node.parent
        upper = RadixNode(
            node.tokens[:k], parent=parent,
            last_access=node.last_access, locks=node.locks,
        )
        if node.pages:  # the page ids split with the edge
            kp = k // self.page_size
            upper.pages = node.pages[:kp]
            node.pages = node.pages[kp:]
        lower_tokens = node.tokens[k:]
        node.tokens = lower_tokens
        node.parent = upper
        upper.children[self._key(lower_tokens)] = node
        parent.children[self._key(upper.tokens)] = upper
        return upper

    def _remove_leaf(self, leaf: RadixNode) -> None:
        self.size_tokens -= len(leaf.tokens)
        self.evicted_tokens += len(leaf.tokens)
        del leaf.parent.children[self._key(leaf.tokens)]
        if leaf.pages:
            if self.pool is not None:
                self.pool.decref(leaf.pages)
            leaf.pages = []

    # -- page payloads (real backend) --------------------------------------
    def attach_pages(self, tokens: Sequence[int],
                     pages: Sequence[int]) -> int:
        """Attach pool pages to the already-inserted path of ``tokens``
        (``pages[i]`` backs tokens ``[i*ps, (i+1)*ps)``); the cache
        takes its own pool reference on every page it retains.  Nodes
        that already carry pages keep them (same token path ⇒ identical
        KV content).  Returns the number of pages newly attached."""
        if self.pool is None or not tokens:
            return 0
        tokens = tuple(tokens[: self._quant(len(tokens))])
        node, matched, attached = self.root, 0, 0
        while matched < len(tokens):
            child = node.children.get(self._key(tokens[matched:]))
            if child is None:
                break
            k = self._common_pages(child.tokens, tokens[matched:])
            if k < len(child.tokens):
                break  # pages attach whole-edge only
            if not child.pages:
                lo = matched // self.page_size
                hi = (matched + k) // self.page_size
                child.pages = list(pages[lo:hi])
                self.pool.incref(child.pages)
                attached += hi - lo
            node, matched = child, matched + k
        return attached

    def match_pages(self, tokens: Optional[Sequence[int]]
                    ) -> Tuple[int, List[int]]:
        """Longest prefix of ``tokens`` covered by *resident pages*:
        ``(n_tokens, page_ids)``, page-aligned and capped at
        ``len(tokens) - 1`` exactly like :meth:`lookup`.  The ids are
        returned un-retained — callers incref before relying on them
        (single-threaded event loop: nothing evicts in between)."""
        if self.pool is None or not tokens:
            return 0, []
        tokens = tuple(tokens)
        node, matched = self.root, 0
        pages: List[int] = []
        while matched < len(tokens):
            child = node.children.get(self._key(tokens[matched:]))
            if child is None:
                break
            k = self._common_pages(child.tokens, tokens[matched:])
            if not child.pages:
                break
            if k < len(child.tokens):
                pages.extend(child.pages[: k // self.page_size])
                matched += k
                break
            pages.extend(child.pages)
            matched += k
            node = child
        n = self._cap(matched, len(tokens))
        return n, pages[: n // self.page_size]
