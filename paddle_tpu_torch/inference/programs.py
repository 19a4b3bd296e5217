"""Compiled device programs of the serving engines: CUDA graphs over
static buffers (the port's counterpart of the JAX engine's jitted
``_decode_k_program``, ``_verify_program`` and ``_propose_k_program``
and their cache, ``_cached_program``).

A :class:`DeviceProgram` is a ``body()`` that reads and writes only
tensors whose storage outlives it — the engine's static input buffers,
its caches, its parameters and the program's own output buffers — so
the same launches can be recorded once and replayed.  Its first run is
eager: the run does the round's real work and does, outside any
capture, everything a first launch does lazily (the kernel build and
load, ``cudaFuncSetAttribute``, the wrappers' plan and occupancy
caches, cuBLAS's handle, the fused kernel's barrier buffer).  Its
second run captures the body on a side stream with
``torch.cuda.graph`` and replays it; every later run only replays.  A
capture executes nothing, so a replay does exactly what an eager run
of the body would do, bit for bit.  A capture or a replay that fails
raises; nothing runs the body eagerly in its place.

A :class:`ProgramCache` holds one engine's programs, keyed by (kind,
steps), and the one memory pool their graphs share (they are replayed
one at a time, in sequence).  A graph binds the addresses of every
buffer it touches, so the cache cannot be shared across engines as
JAX's ``_PROGRAM_CACHE`` is, and :meth:`ProgramCache.drop` must be
called wherever an engine replaces the storage its programs bind.

Launch accounting: the kernel wrappers count launches in Python module
globals (:data:`COUNTERS`), and a replay runs no Python.  So a program
records every counter's change over its capture (when the wrappers ran
but nothing executed), puts the counters back, and adds that change at
each replay: the counts read as if every round had run eagerly.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..incubate.nn.kernels import (flash_decode, fused_decode,
                                   fused_norm_rope, row_gemm, sampling)

__all__ = ["COUNTERS", "snapshot", "restore", "difference", "add",
           "CudaGraph", "DeviceProgram", "ProgramCache", "resolve_capture"]

#: the launch counters of the kernels a serving program can launch:
#: (module, attribute), an int or a dict of ints
COUNTERS = ((flash_decode, "LAUNCHES"), (flash_decode, "PAGED_LAUNCHES"),
            (flash_decode, "MODE_LAUNCHES"),
            (flash_decode, "INSTANCE_LAUNCHES"),
            (fused_decode, "LAUNCHES"), (fused_decode, "MODE_LAUNCHES"),
            (row_gemm, "LAUNCHES"), (sampling, "LAUNCHES"),
            (fused_norm_rope, "LAUNCHES"))


def snapshot() -> Tuple[Any, ...]:
    """The counters' values now (dicts copied)."""
    return tuple(dict(v) if isinstance(v, dict) else v
                 for v in (getattr(m, a) for m, a in COUNTERS))


def restore(snap):
    """Set every counter to ``snap`` (dicts in place: callers may hold
    them)."""
    for (m, a), v in zip(COUNTERS, snap):
        if isinstance(v, dict):
            getattr(m, a).update(v)
        else:
            setattr(m, a, v)


def difference(after, before) -> Tuple[Any, ...]:
    """Each counter's change from ``before`` to ``after``."""
    return tuple({k: n - b.get(k, 0) for k, n in a.items()}
                 if isinstance(a, dict) else a - b
                 for a, b in zip(after, before))


def add(delta):
    """Add a :func:`difference` to the counters."""
    for (m, a), d in zip(COUNTERS, delta):
        if isinstance(d, dict):
            counts = getattr(m, a)
            for k, n in d.items():
                counts[k] = counts.get(k, 0) + n
        else:
            setattr(m, a, getattr(m, a) + d)


class CudaGraph:
    """``body`` captured as a CUDA graph into the memory pool ``pool``
    (None: a new pool, read back as :attr:`pool`).

    Python's cyclic garbage collector is off during the capture: an
    engine is a reference cycle (its programs' bodies refer to it), and
    collecting a dropped engine frees its graphs, a CUDA call that
    invalidates a capture running at that moment.  ``torch.cuda.graph``
    collects once before it begins."""

    def __init__(self, body: Callable[[], None], pool=None):
        self.graph = torch.cuda.CUDAGraph()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                body()
        finally:
            if enabled:
                gc.enable()
        self.pool = self.graph.pool()

    def replay(self):
        self.graph.replay()


class DeviceProgram:
    """One program of an engine (see the module note): ``body()`` over
    static buffers, run eagerly while ``cache.capture`` is off, else
    eagerly once and captured at its second run.  ``outputs`` are the
    program's own output buffers (allocated before its first run, so
    they keep their addresses)."""

    def __init__(self, cache: "ProgramCache", body: Callable[[], None],
                 outputs: Dict[str, Any]):
        self.cache = cache
        self.body = body
        self.outputs = outputs
        self.graph = None
        self.delta = None
        self.runs = 0
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def run(self):
        cache = self.cache
        if self.graph is None and (not cache.capture or self.runs == 0):
            self.body()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            add(self.delta)
            self.replays += 1
            cache.replays += 1
        self.runs += 1

    def _capture(self):
        cache = self.cache
        before = snapshot()
        cuda = cache.device.type == "cuda"
        if cuda:
            # a capture empties the allocator's cache first; doing it
            # here leaves the reserved bytes' growth to the pool alone
            torch.cuda.synchronize(cache.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(cache.device)
        t0 = time.perf_counter()
        try:
            graph = cache.graph_type(self.body, cache.pool)
            after = snapshot()
        finally:
            # the capture ran the wrappers' Python and executed nothing
            restore(before)
        cache.capture_seconds += time.perf_counter() - t0
        if cuda:
            cache.pool_bytes += max(
                0, torch.cuda.memory_reserved(cache.device) - reserved)
        cache.pool = graph.pool
        self.delta = difference(after, before)
        self.graph = graph


class ProgramCache:
    """One engine's programs by (kind, steps), the pool their graphs
    share, and the telemetry of ``metrics()``: the programs, the replays,
    the seconds spent capturing and the bytes the pool took."""

    def __init__(self, device: torch.device, capture: bool):
        self.device = device
        self.capture = capture
        #: what captures a body: :class:`CudaGraph`, or a stand-in with
        #: the same surface (``graph_type(body, pool)``, ``.replay()``,
        #: ``.pool``)
        self.graph_type = CudaGraph
        self.programs: Dict[Tuple[str, int], DeviceProgram] = {}
        self.pool = None
        self.replays = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    def get(self, kind: str, steps: int,
            build: Callable[[], Tuple[Callable[[], None], Dict[str, Any]]]
            ) -> DeviceProgram:
        """The (kind, steps) program, built by ``build() -> (body,
        outputs)`` at its first use."""
        prog = self.programs.get((kind, steps))
        if prog is None:
            body, outputs = build()
            prog = DeviceProgram(self, body, outputs)
            self.programs[(kind, steps)] = prog
        return prog

    def drop(self):
        """Forget every program and the pool: the storage they bind is
        about to be replaced (the pool's memory is freed with the last
        graph)."""
        self.programs.clear()
        self.pool = None
        self.pool_bytes = 0

    def metrics(self) -> Dict[str, Any]:
        return {
            "graphs": {f"{kind}:{steps}": {"captured": p.captured,
                                           "runs": p.runs,
                                           "replays": p.replays}
                       for (kind, steps), p in sorted(self.programs.items())},
            "graph_replays": self.replays,
            "capture_seconds": self.capture_seconds,
            "graph_pool_bytes": self.pool_bytes,
        }


def resolve_capture(cuda_graphs: Optional[bool], device: torch.device
                    ) -> bool:
    """Whether an engine on ``device`` captures its programs: None means
    yes on CUDA (the CPU runs the same programs eagerly), False never,
    True on CUDA only."""
    if cuda_graphs is None:
        return device.type == "cuda"
    if cuda_graphs and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA engine, this one "
                         f"runs on {device}")
    return bool(cuda_graphs)
