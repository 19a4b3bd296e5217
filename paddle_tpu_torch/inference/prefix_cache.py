"""Radix prefix cache for the serving engines (port of
``paddle_tpu/inference/prefix_cache.py``: ``KVSpanPayload``,
``PagePayload``, ``HostPagePayload``, the trie and its two tiers).

Identical prompt prefixes — system prompts, few-shot headers, chat
history — recur across requests.  The cache keeps the K/V of prefilled
prompts in an edge-compressed radix trie keyed on token ids; on
admission an engine looks up the longest cached prefix, installs it
into the request's slot and prefills only the suffix.

The trie is engine-agnostic: each node owns a token span and an opaque
payload holding that span's K/V in the engine's form:

* :class:`KVSpanPayload` — contiguous and fused engines: copies of the
  span's K/V rows (any layout whose token axis is given), sliced at
  token granularity; a split's halves are views of the one copy.
* :class:`PagePayload` — the paged engine: refcounted page ids into its
  pool.  No bytes are copied; the cache co-owns the pages (the engine's
  per-page refcount keeps them out of the free list) and a hit installs
  the shared ids straight into the slot's block table.  Only pages that
  lie fully inside a span are kept; a page straddling an edge split is
  released (a shorter usable prefix, never wrong K/V).
* :class:`HostPagePayload` — a paged span's fully covered pages copied
  to host RAM (the host tier of a paged engine).

Eviction is leaf-first LRU under a byte budget: every match and insert
touches the path, and :meth:`RadixPrefixCache.insert` evicts the least
recently used spans until the cache fits.  Evicting a payload calls its
``release()`` (paged: the refcount decrement).

The host tier (``host_capacity_bytes``): a span evicted under the
device budget is DEMOTED — ``payload.demote()`` copies its K/V to host
RAM (one device-to-host copy a span, finished before the call returns;
paged spans gather their pages and then release the refcounts) and the
node keeps its place with the host payload.  A match walks through host
nodes as through device ones; the engine decides how to consume them
(an asynchronous host-to-device reinstall, ``serving``).
:meth:`RadixPrefixCache.promote` swaps a host payload back for a device
payload in place once the engine has reinstalled it.  The host tier has
its own LRU budget, and eviction there is final: device → host → gone.
Host payloads hold torch CPU tensors, pinned when they come from a CUDA
device (the caching host allocator's blocks, so an asynchronous copy
out of one keeps it alive until the copy's event completes), unpinned
on a CPU engine.  A failed demotion degrades to a drop.
:meth:`RadixPrefixCache.export_spans` lists every span, parents first,
for the live handoff (``inference.handoff``).  The cache is driven by
the single-threaded host scheduler, so it takes no locks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..incubate.nn.kv_quant import byte_view, kv_components, kv_map, kv_nbytes

__all__ = ["RadixPrefixCache", "KVSpanPayload", "PagePayload",
           "HostPagePayload", "to_host", "host_select"]


def to_host(x: torch.Tensor) -> torch.Tensor:
    """An owned, contiguous host copy of ``x``.  From a CUDA tensor: a
    pinned buffer of the caching host allocator, filled by a blocking
    copy on the current stream (the bytes have landed, and the work
    queued before it has run, when this returns); from a CPU tensor: a
    plain clone.  fp8 is copied as its bytes."""
    src = byte_view(x)
    if src.is_cuda:
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        out.copy_(src)
    else:
        out = src.clone(memory_format=torch.contiguous_format)
    return out.view(x.dtype)


def _contiguous_host(x: torch.Tensor) -> torch.Tensor:
    """A host view as an owned contiguous tensor (pinned if the view's
    memory is): the source one asynchronous copy can take as it is."""
    if x.is_contiguous():
        return x
    src = byte_view(x)
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=x.is_pinned())
    out.copy_(src)
    return out.view(x.dtype)


def host_select(x: torch.Tensor, idx: List[int]) -> torch.Tensor:
    """``x[:, idx]`` of a host tensor into a new one, pinned if ``x``
    is: a plain fancy index would hand back pageable memory."""
    src = byte_view(x)
    out = torch.empty((src.shape[0], len(idx)) + tuple(src.shape[2:]),
                      dtype=src.dtype, pin_memory=x.is_pinned())
    torch.index_select(src, 1, torch.tensor(idx, dtype=torch.long), out=out)
    return out.view(x.dtype)


class KVSpanPayload:
    """K/V copies for a token span: ``k``/``v`` tensors whose
    ``token_axis`` dimension is the span length (contiguous engines
    [L, span, nH, hD]; the fused flat layout [L, span, H]).  Under int8
    storage each of ``k``/``v`` is a ``(data, scale)`` pair whose scale
    plane mirrors the data's axes through the token axis, so every slice
    applies to both.  ``tier`` is ``"device"`` (the engine's tensors) or
    ``"host"`` (host copies made by :meth:`demote`)."""

    def __init__(self, k, v, token_axis: int = 1, tier: str = "device"):
        self.k = k
        self.v = v
        self.token_axis = token_axis
        self.tier = tier

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
        """Device halves are views of the one copy; host halves are
        contiguous copies, so that every reinstall of them is one copy
        straight from their memory."""
        own = _contiguous_host if self.tier == "host" else (lambda x: x)
        left, right = self._index(slice(0, n)), self._index(slice(n, None))
        return (KVSpanPayload(kv_map(lambda x: own(x[left]), self.k),
                              kv_map(lambda x: own(x[left]), self.v),
                              self.token_axis, self.tier),
                KVSpanPayload(kv_map(lambda x: own(x[right]), self.k),
                              kv_map(lambda x: own(x[right]), self.v),
                              self.token_axis, self.tier))

    def demote(self) -> Optional["KVSpanPayload"]:
        """Device → host: owned host copies (:func:`to_host`, one
        blocking copy a tensor; it runs on the eviction path, never in a
        decode round).  The round trip is byte-exact, so a reinstalled
        span gives the device K/V back bit for bit."""
        if self.tier == "host":
            return None
        return KVSpanPayload(kv_map(to_host, self.k), kv_map(to_host, self.v),
                             self.token_axis, tier="host")

    def release(self) -> None:
        """Nothing to do: the tensors are owned copies."""


class PagePayload:
    """Refcounted page ids for a token span [start, start + length).

    ``pages`` maps the global page number (position // block_size) to
    the page id in the engine's pool, for pages FULLY covered by the
    span.  ``release_cb(page_ids)`` is the engine's refcount decrement,
    called once when pages leave the cache (eviction, or a split that
    drops a straddled page).  ``gather_cb(page_ids)`` (optional) is the
    engine's page read to host memory: it makes the payload demotable."""

    tier = "device"

    def __init__(self, start: int, length: int, pages: Dict[int, int],
                 block_size: int, page_bytes: int,
                 release_cb: Callable[[List[int]], None],
                 gather_cb: Optional[Callable[[List[int]], Tuple]] = None):
        self.start = int(start)
        self.length = int(length)
        self.pages = dict(pages)
        self.block_size = int(block_size)
        self.page_bytes = int(page_bytes)
        self.release_cb = release_cb
        self.gather_cb = gather_cb

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
                            self.release_cb, self.gather_cb),
                PagePayload(cut, self.length - n, right, bs,
                            self.page_bytes, self.release_cb,
                            self.gather_cb))

    def demote(self) -> Optional["HostPagePayload"]:
        """Device → host: gather the span's pages to host memory
        (``gather_cb``, which returns only once the copy has landed) and
        THEN release the refcounts, so a page freed here and claimed by
        the next prefill cannot be read into the host copy.  None (the
        caller drops instead) when there are no pages or no gather
        seam."""
        if not self.pages or self.gather_cb is None:
            return None
        js = sorted(self.pages)
        k, v = self.gather_cb([self.pages[j] for j in js])
        host = HostPagePayload(self.start, self.length,
                               {j: i for i, j in enumerate(js)},
                               self.block_size, k, v)
        self.release()
        return host

    def release(self) -> None:
        if self.pages:
            self.release_cb(list(self.pages.values()))
            self.pages = {}


class HostPagePayload:
    """Host copy of a paged span's fully covered pages.

    ``pages`` maps the global page number to the index along axis 1 of
    the host ``k``/``v`` tensors ([L, n_pages, block_size, ...]).  A hit
    on it claims fresh pool pages, copies these contents into them (the
    paged engine's reinstall) and :meth:`RadixPrefixCache.promote` swaps
    this payload for a refcounted :class:`PagePayload` in place."""

    tier = "host"

    def __init__(self, start: int, length: int, pages: Dict[int, int],
                 block_size: int, k, v):
        self.start = int(start)
        self.length = int(length)
        self.pages = dict(pages)
        self.block_size = int(block_size)
        self.k = k
        self.v = v

    @property
    def nbytes(self) -> int:
        return kv_nbytes(self.k) + kv_nbytes(self.v)

    def usable_pages(self, matched: int) -> Dict[int, int]:
        """Pages of this span fully inside its first ``matched`` tokens
        (as :meth:`PagePayload.usable_pages`; the values are host
        indices, not pool page ids)."""
        end = self.start + min(matched, self.length)
        return {j: i for j, i in self.pages.items()
                if (j + 1) * self.block_size <= end}

    def split(self, n: int) -> Tuple["HostPagePayload", "HostPagePayload"]:
        cut = self.start + n
        bs = self.block_size

        def take(js, start, length):
            idx = [self.pages[j] for j in js]
            return HostPagePayload(
                start, length, {j: i for i, j in enumerate(js)}, bs,
                kv_map(lambda x: host_select(x, idx), self.k),
                kv_map(lambda x: host_select(x, idx), self.v))

        left = sorted(j for j in self.pages if (j + 1) * bs <= cut)
        right = sorted(j for j in self.pages if j * bs >= cut)
        # a straddled page is dropped, as the device split drops it
        return take(left, self.start, n), take(right, cut, self.length - n)

    def demote(self) -> None:
        return None          # already in host memory

    def release(self) -> None:
        self.pages = {}      # owned copies


class _Node:
    __slots__ = ("edge", "children", "payload", "parent", "tick", "charged")

    def __init__(self, edge: np.ndarray, payload,
                 parent: Optional["_Node"]):
        self.edge = edge                      # tokens from parent to here
        self.children: Dict[int, _Node] = {}
        self.payload = payload                # None only for the root
        self.parent = parent
        self.tick = 0
        self.charged = 0                      # bytes counted at attach


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class RadixPrefixCache:
    """Edge-compressed radix trie over token-id sequences with LRU
    eviction under ``capacity_bytes`` (None: no budget).

    ``match(tokens)`` returns ``(length, spans)``: the longest cached
    prefix of ``tokens`` and, in order, ``(payload, matched_in_span)``
    pairs covering it (the last span may be matched in part).
    ``insert(tokens, make_payload)`` adds the missing tail, calling
    ``make_payload(a, b)`` for the new node's token span [a, b).

    ``host_capacity_bytes`` — the host tier's budget (0, the default:
    one tier; None: unbounded).  With it, a device-budget eviction calls
    ``demoter(payload)`` (default ``payload.demote()``; the engines route
    it through their device-call funnel) and keeps the node with the
    host payload it returns; a demoter that returns None or raises
    degrades to a plain drop.  ``on_demote(host_payload)`` is the
    engines' counter seam."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 on_evict: Optional[Callable[[Any], None]] = None,
                 host_capacity_bytes: Optional[int] = 0,
                 demoter: Optional[Callable[[Any], Any]] = None,
                 on_demote: Optional[Callable[[Any], None]] = None):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0 or None")
        if host_capacity_bytes is not None and host_capacity_bytes < 0:
            raise ValueError("host_capacity_bytes must be >= 0 or None")
        self.capacity_bytes = capacity_bytes
        self.host_capacity_bytes = host_capacity_bytes
        self.on_evict = on_evict
        self.on_demote = on_demote
        self._demoter = (demoter if demoter is not None
                         else lambda p: p.demote())
        self._root = _Node(np.zeros(0, np.int32), None, None)
        self._tick = 0
        self.bytes = 0            # device-tier payload bytes
        self.host_bytes = 0       # host-tier payload bytes
        self.entries = 0          # live payload-bearing nodes (both tiers)
        self.host_entries = 0     # of which in the host tier
        self.hits = 0             # matches with length > 0
        self.misses = 0
        self.hit_tokens = 0       # tokens served from the cache
        self.evictions = 0
        # the tier transitions (device -> host -> gone)
        self.demotions = 0
        self.promotions = 0
        self.host_evictions = 0
        self.host_hits = 0        # matches touching a host span
        self.host_hit_tokens = 0  # their tokens on host spans
        # tokens added by decode-span extensions (insert(extend=True):
        # accepted output cached at retirement), apart from prompt
        # inserts
        self.extended_tokens = 0

    @property
    def host_tier_enabled(self) -> bool:
        return (self.host_capacity_bytes is None
                or self.host_capacity_bytes > 0)

    # -- internals -----------------------------------------------------------
    def _attach(self, node: _Node, payload) -> None:
        """Bind ``payload`` to ``node``, counting its bytes in its tier;
        the back reference lets :meth:`promote` find the node."""
        node.payload = payload
        node.charged = payload.nbytes
        payload._node = node
        if payload.tier == "host":
            self.host_bytes += node.charged
            self.host_entries += 1
        else:
            self.bytes += node.charged
        self.entries += 1

    def _detach(self, node: _Node) -> None:
        # the bytes counted at attach: a paged payload's demote releases
        # its pages (nbytes 0) before the node lets it go
        payload = node.payload
        if payload.tier == "host":
            self.host_bytes -= node.charged
            self.host_entries -= 1
        else:
            self.bytes -= node.charged
        self.entries -= 1
        payload._node = None

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
        tokens of ``tokens`` the trie covers, and how many of them lie
        on host payloads.  Touches no counter and no LRU order."""
        key = np.asarray(tokens, np.int32).reshape(-1)
        _, length, spans = self._walk(key)
        host = 0
        for n, m in spans:
            if n.payload is None:
                length -= m
            elif n.payload.tier == "host":
                host += m
        return max(length, 0), host

    def match(self, tokens) -> Tuple[int, List[Tuple[Any, int]]]:
        key = np.asarray(tokens, np.int32).reshape(-1)
        _, length, spans = self._walk(key)
        if spans:
            self._touch(spans[-1][0])
        if length > 0:
            self.hits += 1
            self.hit_tokens += length
            htok = sum(m for n, m in spans if n.payload.tier == "host")
            if htok:
                self.host_hits += 1
                self.host_hit_tokens += htok
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
        """Both budgets.  Device tier: demote the least recently used
        device span to the host tier (any node: a demotion keeps the
        trie's shape), or, with the host tier off or the demotion
        failed, drop it leaf-first (an interior node is skipped for the
        rest of the pass: its children would be orphaned).  Host tier:
        drop the least recently used host leaves."""
        if self.capacity_bytes is not None:
            skip: set = set()
            while self.bytes > self.capacity_bytes:
                cands = [n for n in self._payload_nodes()
                         if n.payload.tier != "host" and id(n) not in skip]
                if not cands:
                    break
                node = min(cands, key=lambda n: n.tick)
                if self.host_tier_enabled and self._demote_node(node):
                    continue
                if node.children:
                    skip.add(id(node))
                else:
                    self._drop(node)
        if self.host_capacity_bytes is not None:
            while self.host_bytes > self.host_capacity_bytes:
                leaves = [n for n in self._leaves()
                          if n.payload.tier == "host"]
                if not leaves:
                    break    # only interior host nodes remain
                self.host_evictions += 1
                self._drop(min(leaves, key=lambda n: n.tick))

    def _demote_node(self, node: _Node) -> bool:
        """Swap ``node``'s device payload for its host demotion; False
        (the caller drops instead) when the demoter declines or raises:
        a failed copy costs capacity, never correctness."""
        try:
            host = self._demoter(node.payload)
        except Exception:  # noqa: BLE001 — degrade to a plain drop
            host = None
        if host is None:
            return False
        self._detach(node)
        self._attach(node, host)
        self.demotions += 1
        if self.on_demote is not None:
            self.on_demote(host)
        return True

    def promote(self, payload, device_payload) -> bool:
        """Swap the host payload ``payload`` for ``device_payload`` in
        place (the engine has just reinstalled its contents).  False
        when the payload no longer sits on a live node (a host-tier
        eviction overtook the reinstall): the caller keeps its copy
        unshared."""
        node = getattr(payload, "_node", None)
        if node is None or node.payload is not payload:
            return False
        self._detach(node)
        self._attach(node, device_payload)
        self.promotions += 1
        self._touch(node)
        self._evict_to_budget()
        return True

    def drop_device_entries(self) -> int:
        """Drop every DEVICE span, subtrees included (a prefix walk
        cannot reach a dead span's children), and keep the host spans
        above them.  The paged engine calls this before its pool is
        rebuilt: cached page ids would point into the dead pool, but
        host copies stay valid.  Returns the number of nodes dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.payload.tier != "host":
                dropped += self._drop_subtree(node)
            else:
                stack.extend(node.children.values())
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

    # -- the handoff's export ------------------------------------------------
    def export_spans(self) -> List[Tuple[np.ndarray, int, int, Any]]:
        """Every payload-bearing node as ``(key, a, b, payload)``: the
        root-to-node token path (length ``b``) and the node's own span
        [a, b).  Parents come before children, so inserting the records
        in order rebuilds the trie's shape in another cache.  Read only:
        the payloads stay this cache's."""
        out: List[Tuple[np.ndarray, int, int, Any]] = []
        stack: List[Tuple[_Node, np.ndarray]] = [
            (self._root, np.zeros(0, np.int32))]
        while stack:
            node, key = stack.pop()
            for child in node.children.values():
                ck = np.concatenate([key, child.edge])
                out.append((ck, key.size, ck.size, child.payload))
                stack.append((child, ck))
        out.sort(key=lambda r: r[2])   # depth order: parents first
        return out

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"bytes": self.bytes, "entries": self.entries,
                "hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "extended_tokens": self.extended_tokens,
                "evictions": self.evictions,
                "capacity_bytes": self.capacity_bytes,
                "host_bytes": self.host_bytes,
                "host_entries": self.host_entries,
                "host_capacity_bytes": self.host_capacity_bytes,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "host_evictions": self.host_evictions,
                "host_hits": self.host_hits,
                "host_hit_tokens": self.host_hit_tokens}
