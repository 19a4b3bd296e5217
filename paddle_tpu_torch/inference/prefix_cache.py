"""Radix prefix cache for the serving engines (port of
``paddle_tpu/inference/prefix_cache.py``: ``KVSpanPayload``,
``PagePayload``, the trie and its device tier).

Identical prompt prefixes — system prompts, few-shot headers, chat
history — recur across requests.  The cache keeps the K/V of prefilled
prompts in an edge-compressed radix trie keyed on token ids; on
admission an engine looks up the longest cached prefix, installs it
into the request's slot and prefills only the suffix.

The trie is engine-agnostic: each node owns a token span and an opaque
payload holding that span's K/V in the engine's form:

* :class:`KVSpanPayload` — contiguous and fused engines: device copies
  of the span's K/V rows (any layout whose token axis is given), sliced
  at token granularity; a split's halves are views of the one copy.
* :class:`PagePayload` — the paged engine: refcounted page ids into its
  pool.  No bytes are copied; the cache co-owns the pages (the engine's
  per-page refcount keeps them out of the free list) and a hit installs
  the shared ids straight into the slot's block table.  Only pages that
  lie fully inside a span are kept; a page straddling an edge split is
  released (a shorter usable prefix, never wrong K/V).

Eviction is leaf-first LRU under a byte budget: every match and insert
touches the path, and :meth:`RadixPrefixCache.insert` evicts the least
recently used leaves until the cache fits.  Evicting a payload calls its
``release()`` (paged: the refcount decrement).

Left out of this port: the host-RAM tier (``HostPagePayload``,
``demote`` / ``promote``, ``host_capacity_bytes > 0``; ROADMAP Queue 1
item 2b) and the handoff export (``export_spans``, item 9).  The cache
is driven by the single-threaded host scheduler, so it takes no locks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..incubate.nn.kv_quant import kv_components, kv_map, kv_nbytes

__all__ = ["RadixPrefixCache", "KVSpanPayload", "PagePayload"]


class KVSpanPayload:
    """K/V copies for a token span: ``k``/``v`` tensors whose
    ``token_axis`` dimension is the span length (contiguous engines
    [L, span, nH, hD]; the fused flat layout [L, span, H]).  Under int8
    storage each of ``k``/``v`` is a ``(data, scale)`` pair whose scale
    plane mirrors the data's axes through the token axis, so every slice
    applies to both."""

    tier = "device"

    def __init__(self, k, v, token_axis: int = 1):
        self.k = k
        self.v = v
        self.token_axis = token_axis

    @property
    def nbytes(self) -> int:
        # stored bytes, scale planes included: what the budget charges
        return kv_nbytes(self.k) + kv_nbytes(self.v)

    def take(self, n: int):
        """(k, v) of the first n tokens."""
        idx = self._index(slice(0, n))
        return (kv_map(lambda x: x[idx], self.k),
                kv_map(lambda x: x[idx], self.v))

    def _index(self, sl):
        ndim = kv_components(self.k)[0].dim()
        return tuple(sl if d == self.token_axis else slice(None)
                     for d in range(ndim))

    def split(self, n: int) -> Tuple["KVSpanPayload", "KVSpanPayload"]:
        left, right = self._index(slice(0, n)), self._index(slice(n, None))
        return (KVSpanPayload(kv_map(lambda x: x[left], self.k),
                              kv_map(lambda x: x[left], self.v),
                              self.token_axis),
                KVSpanPayload(kv_map(lambda x: x[right], self.k),
                              kv_map(lambda x: x[right], self.v),
                              self.token_axis))

    def release(self) -> None:
        """Nothing to do: the tensors are owned copies."""


class PagePayload:
    """Refcounted page ids for a token span [start, start + length).

    ``pages`` maps the global page number (position // block_size) to
    the page id in the engine's pool, for pages FULLY covered by the
    span.  ``release_cb(page_ids)`` is the engine's refcount decrement,
    called once when pages leave the cache (eviction, or a split that
    drops a straddled page)."""

    tier = "device"

    def __init__(self, start: int, length: int, pages: Dict[int, int],
                 block_size: int, page_bytes: int,
                 release_cb: Callable[[List[int]], None]):
        self.start = int(start)
        self.length = int(length)
        self.pages = dict(pages)
        self.block_size = int(block_size)
        self.page_bytes = int(page_bytes)
        self.release_cb = release_cb

    @property
    def nbytes(self) -> int:
        # the pages are shared with the pool, but the cache pins them
        # against reuse: budget them at full page cost
        return len(self.pages) * self.page_bytes

    def usable_pages(self, matched: int) -> Dict[int, int]:
        """Pages of this span fully inside its first ``matched``
        tokens."""
        end = self.start + min(matched, self.length)
        return {j: p for j, p in self.pages.items()
                if (j + 1) * self.block_size <= end}

    def split(self, n: int) -> Tuple["PagePayload", "PagePayload"]:
        cut = self.start + n
        bs = self.block_size
        left = {j: p for j, p in self.pages.items() if (j + 1) * bs <= cut}
        right = {j: p for j, p in self.pages.items() if j * bs >= cut}
        straddle = [p for j, p in self.pages.items()
                    if j not in left and j not in right]
        if straddle:
            # the page spans the split point: neither side covers it
            # fully any more, so the cache gives up its claim
            self.release_cb(straddle)
        return (PagePayload(self.start, n, left, bs, self.page_bytes,
                            self.release_cb),
                PagePayload(cut, self.length - n, right, bs,
                            self.page_bytes, self.release_cb))

    def release(self) -> None:
        if self.pages:
            self.release_cb(list(self.pages.values()))
            self.pages = {}


class _Node:
    __slots__ = ("edge", "children", "payload", "parent", "tick")

    def __init__(self, edge: np.ndarray, payload,
                 parent: Optional["_Node"]):
        self.edge = edge                      # tokens from parent to here
        self.children: Dict[int, _Node] = {}
        self.payload = payload                # None only for the root
        self.parent = parent
        self.tick = 0


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class RadixPrefixCache:
    """Edge-compressed radix trie over token-id sequences with leaf-first
    LRU eviction under ``capacity_bytes`` (None: no budget).

    ``match(tokens)`` returns ``(length, spans)``: the longest cached
    prefix of ``tokens`` and, in order, ``(payload, matched_in_span)``
    pairs covering it (the last span may be matched in part).
    ``insert(tokens, make_payload)`` adds the missing tail, calling
    ``make_payload(a, b)`` for the new node's token span [a, b).
    ``host_capacity_bytes`` is the JAX cache's second tier: 0 (off) is
    the only value this port takes."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 on_evict: Optional[Callable[[Any], None]] = None,
                 host_capacity_bytes: Optional[int] = 0):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0 or None")
        if host_capacity_bytes is None or host_capacity_bytes > 0:
            raise NotImplementedError(
                "the prefix cache's host-RAM tier is not ported yet "
                "(ROADMAP Queue 1 item 2b); pass host_capacity_bytes=0")
        if host_capacity_bytes < 0:
            raise ValueError("host_capacity_bytes must be >= 0 or None")
        self.capacity_bytes = capacity_bytes
        self.host_capacity_bytes = 0
        self.on_evict = on_evict
        self._root = _Node(np.zeros(0, np.int32), None, None)
        self._tick = 0
        self.bytes = 0            # payload bytes
        self.entries = 0          # live payload-bearing nodes
        self.hits = 0             # matches with length > 0
        self.misses = 0
        self.hit_tokens = 0       # tokens served from the cache
        self.evictions = 0
        # tokens added by decode-span extensions (insert(extend=True):
        # accepted output cached at retirement), apart from prompt
        # inserts
        self.extended_tokens = 0

    # -- internals -----------------------------------------------------------
    def _attach(self, node: _Node, payload) -> None:
        node.payload = payload
        self.bytes += payload.nbytes
        self.entries += 1

    def _detach(self, node: _Node) -> None:
        self.bytes -= node.payload.nbytes
        self.entries -= 1

    def _payload_nodes(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        while node is not None and node is not self._root:
            node.tick = self._tick
            node = node.parent

    def _walk(self, key: np.ndarray):
        """Longest-prefix walk: (node, consumed, spans) — the deepest
        FULLY matched node, the tokens matched, and the ordered (node,
        matched) pairs including a final partly matched child."""
        node, i = self._root, 0
        spans: List[Tuple[_Node, int]] = []
        while i < key.size:
            child = node.children.get(int(key[i]))
            if child is None:
                break
            m = _common_prefix(child.edge, key[i:])
            if m == 0:
                break
            spans.append((child, m))
            i += m
            if m < child.edge.size:
                break
            node = child
        return node, i, spans

    # -- read path -----------------------------------------------------------
    def probe(self, tokens) -> Tuple[int, int]:
        """Read-only probe: ``(matched, host_matched)`` — the leading
        tokens of ``tokens`` the trie covers (host_matched is always 0
        here: no host tier).  Touches no counter and no LRU order."""
        key = np.asarray(tokens, np.int32).reshape(-1)
        _, length, spans = self._walk(key)
        for n, m in spans:
            if n.payload is None:
                length -= m
        return max(length, 0), 0

    def match(self, tokens) -> Tuple[int, List[Tuple[Any, int]]]:
        key = np.asarray(tokens, np.int32).reshape(-1)
        _, length, spans = self._walk(key)
        if spans:
            self._touch(spans[-1][0])
        if length > 0:
            self.hits += 1
            self.hit_tokens += length
        else:
            self.misses += 1
        return length, [(n.payload, m) for n, m in spans]

    # -- write path ----------------------------------------------------------
    def insert(self, tokens, make_payload: Callable[[int, int], Any],
               extend: bool = False) -> int:
        """Insert ``tokens``, creating a payload for the uncovered tail;
        returns the number of NEW tokens now cached.  ``extend=True``
        marks a decode-span extension (the engines cache a request's
        accepted output at retirement; only emitted tokens reach this
        path, which keeps rejected speculative suffixes out of the
        trie): the count goes to ``extended_tokens``."""
        key = np.asarray(tokens, np.int32).reshape(-1)
        if key.size == 0:
            return 0
        node, i, spans = self._walk(key)
        if spans and spans[-1][1] < spans[-1][0].edge.size:
            # diverged (or ran out) inside the last child's edge: split
            # it so the shared part becomes a full node
            child, m = spans[-1]
            node = self._split(child, m)
        if i >= key.size:
            self._touch(node)
            return 0
        tail = _Node(key[i:], None, node)
        node.children[int(key[i])] = tail
        self._attach(tail, make_payload(i, key.size))
        if extend:
            self.extended_tokens += key.size - i
        self._touch(tail)
        self._evict_to_budget()
        return key.size - i

    def _split(self, child: _Node, m: int) -> _Node:
        """parent --edge[:m]--> mid --edge[m:]--> child.  Payload bytes
        can shrink (paged spans drop straddled pages)."""
        left, right = child.payload.split(m)
        self._detach(child)
        mid = _Node(child.edge[:m], None, child.parent)
        mid.tick = child.tick
        child.parent.children[int(child.edge[0])] = mid
        child.edge = child.edge[m:]
        child.parent = mid
        mid.children[int(child.edge[0])] = child
        self._attach(mid, left)
        self._attach(child, right)
        return mid

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self._root:
                out.append(n)
            stack.extend(kids)
        return out

    def _evict_to_budget(self) -> None:
        """Drop least-recently-used spans until the payload bytes fit.
        An interior node is never dropped (its children would be
        orphaned): it is skipped for the rest of the pass, as in JAX."""
        if self.capacity_bytes is None:
            return
        skip: set = set()
        while self.bytes > self.capacity_bytes:
            cands = [n for n in self._payload_nodes() if id(n) not in skip]
            if not cands:
                break
            node = min(cands, key=lambda n: n.tick)
            if node.children:
                skip.add(id(node))
            else:
                self._drop(node)

    def drop_device_entries(self) -> int:
        """Drop every span (subtrees included).  The paged engine calls
        this before its pool is rebuilt: cached page ids would point
        into the dead pool.  Returns the number of nodes dropped."""
        dropped = 0
        for node in list(self._root.children.values()):
            dropped += self._drop_subtree(node)
        return dropped

    def _drop_subtree(self, node: _Node) -> int:
        node.parent.children.pop(int(node.edge[0]))
        nodes, stack = [], [node]
        while stack:
            n = stack.pop()
            nodes.append(n)
            stack.extend(n.children.values())
        for n in nodes:
            self._detach(n)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(n.payload)
            n.payload.release()
        return len(nodes)

    def _drop(self, leaf: _Node) -> None:
        leaf.parent.children.pop(int(leaf.edge[0]))
        self._detach(leaf)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(leaf.payload)
        leaf.payload.release()

    def clear(self) -> None:
        """Drop everything."""
        while self.entries:
            for leaf in self._leaves():
                self._drop(leaf)

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"bytes": self.bytes, "entries": self.entries,
                "hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "extended_tokens": self.extended_tokens,
                "evictions": self.evictions,
                "capacity_bytes": self.capacity_bytes}
