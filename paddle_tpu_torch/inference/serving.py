"""Continuous-batching serving engines over the KV cache (port of
``paddle_tpu/inference/serving.py``: ``Request``, ``_derive_buckets``,
``SpeculativeConfig``, the scheduler core of
``ContinuousBatchingEngine``, ``PagedContinuousBatchingEngine`` and
``FusedB1Engine``, seeded sampling and speculative decoding on all
three).

The host runs the scheduler — admission, retirement, slot assignment —
and the device runs two programs over one in-place KV cache:

* a batched admission prefill: every request admitted in a round whose
  sequence falls in the same length bucket is prefilled together, ids
  padded with 0 to the bucket, each sequence's K/V written straight
  into its slot (``gpt.prefill_into_slots``) or its pages
  (``gpt.prefill_paged_batched``);
* a K-step decode loop (the engine's decode step + the token draw per
  step: greedy argmax, or the position-keyed sampler) advancing every
  slot at its own position, with ONE host sync per K steps.

Compiled programs (``cuda_graphs``): the K-step decode loop, the
speculative verify pass and the draft's k steps are device programs
over static buffers (``programs.DeviceProgram``; the JAX engine's
``_decode_k_program``, ``_verify_program`` and ``_propose_k_program``),
kept in a per-engine cache keyed by (kind, steps) — temperature, top-k,
top-p, eos, ``attn_kernel`` and ``kv_dtype`` are constants of an
engine, so they are not in the key.  A round copies its host state
(token, position, done flag and seed a slot, the paged block tables,
n-gram drafts) into the static buffers with ``copy_``, runs the program and
reads its output back once.  On a CUDA engine a program's first round
runs eagerly and its second captures it as a CUDA graph, so every
later round is one graph replay; on the CPU the same programs run
eagerly.  A graph binds buffer addresses, so this cache is one
engine's own (JAX's is shared across engines): replacing the cache
storage (``_reset_cache``, ``_init_draft_cache``) drops the programs
and their memory pool.  Prefix installs, suffix fills and admission
prefills write the cache in place, outside any program, and need no
invalidation.

Priming follows the JAX engine: sequences pad to a bucket, so an
admitted slot starts at ``pos = S-1`` feeding its last real token; the
first decode step recomputes that row and its draw is the next
token.  Inactive slots decode at ``max_len-1`` with ``done`` set: the
contiguous engine writes junk rows that no query attends, the paged
engine drops their writes (their block tables are all -1).  The
scheduler makes the same choices as the JAX one step for step, so
greedy and sampled streams match it.

Sampling (``temperature`` > 0, with ``top_k`` / ``top_p``): the token
fed at position p of a request is drawn with ``fold_in(PRNGKey(seed),
p)`` (``decoding.sample_token_pos``; the seed is ``submit(seed=...)``,
loaded per slot with each round), so a stream is a function of (seed,
positions) and the same under any ``steps_per_sync``, with or without
speculation, on all three engines.  On the card the draw is the
sampler kernel (``incubate/nn/kernels/sampling.py``), one launch a
decode step or verify pass.

The KV cache is stored as ``kv_dtype`` ("bf16" = the model dtype,
"int8" with per-row scales, "fp8"); every write quantizes on the way
in and the flash kernel dequantizes while it reads.

Speculative decoding (``speculative=``): a round proposes k
tokens a slot — k greedy steps of a small GPT or LLaMA draft over its
own contiguous cache, or the host n-gram proposer — then ONE verify
pass of the target over each slot's k+1-token window, and one host
sync reads the fed window and the target's tokens together.  The
accepted prefix plus the target's correction token are emitted; every
emitted token is the target's own (argmax, or its draw at that absolute
position: ``decoding.sample_window``), so the stream equals the
non-speculative one, sampled or greedy.  Rollback is host state: rows
of a rejected suffix are never attended and the next fed token
overwrites its row (paged: their pages stay claimed as headroom until
retirement).

Prefix cache (``prefix_cache_bytes``): a radix trie of prefilled
prompts (``prefix_cache.RadixPrefixCache``).  An admission that finds
its sequence's prefix cached installs those K/V rows into its slot
(paged: shares the cached pages through its block table) and fills only
the suffix, as ONE windowed pass of the decode block over the suffix
(``gpt.verify_into_slots`` / ``verify_paged`` without the head; the
fused engine runs its own decode step a token).  A DONE retirement
extends the trie with the request's emitted output, so rejected
speculative tokens never enter it.

Robustness and lifecycle (the JAX engine's contract): every request
reaches a terminal status (DONE, FAILED, TIMEOUT, CANCELLED, REJECTED);
a transient device fault never changes a token; a hung step or a
shutdown is bounded.  Every device call — prefill, decode, verify,
draft, prefix install and suffix fill — goes through ONE funnel
(:meth:`ContinuousBatchingEngine._device_call`): bounded retries with
backoff (``retry``), each attempt under a watchdog deadline
(``step_timeout``), and ``_device_invoke`` as the one override point of
``testing.faults.inject_engine_faults``.  A failed decode or
speculative round leaves its requests in their slots and lets the
circuit breaker judge the device; a failed admission is retried one
member at a time and the failing request is quarantined FAILED (the
poison-pill guard).  ``submit(ttl=, deadline=)``, ``cancel``,
``forget``, the ``shed-oldest`` / ``block`` overload policies, the
breaker's fail-fast and half-open probe, ``prefill_budget`` and
``drain(timeout)`` follow the JAX engine.

The host tier of the prefix cache (``prefix_host_bytes``): a span
evicted under the device budget is demoted to host memory (one blocking
device-to-host copy, funnel kind "demote"; paged spans gather their
pages and then release them) instead of dropped.  An admission whose
matched prefix lies on host spans reserves its slot (paged: fresh pool
pages for the host pages) and starts ONE asynchronous host-to-device
copy a tensor on the engine's side stream (``io.device_put_async``,
funnel kind "reinstall"); the request is INSTALLING, and the decode
rounds go on without it (a reserved slot is inactive to the round).
Each step polls the copies' events first (``_poll_installs``, outside
every program: an event query is not allowed during a capture); a
finished copy is installed in place (the current stream waits on its
event; paged: one ``index_copy_`` of the pages a tensor), the suffix is
filled as on a device hit, the span is promoted back to the device tier
and the request becomes RUNNING.  A failed or timed-out reinstall
(``install_timeout``) sends the request back to the queue front to
re-prefill (never to FAILED); cancel, TTL, ``_retire_all`` and both
drains resolve INSTALLING requests.  Decode never waits on the side
stream; only a step with no slot decoding blocks on the oldest copy
(``_await_install``).

Live handoff: ``drain(mode="handoff")`` stops at a step boundary,
aborts in-flight reinstalls back to QUEUED, caches each running slot's
rows in the prefix cache and parks every live request in the queue;
``export_cache_spans`` writes the trie out span by span in the
canonical ``[L, tokens, nH, hD]`` layout (funnel kind "snapshot"), and
a successor's ``restore_requests`` and host-tier imports
(``_canonical_to_payload``) take them back, on any of the three
layouts (``inference.handoff`` writes and reads the bundle).

Known differences from the JAX engine.  The port writes its caches in
place and its programs read static buffers that only a round's
``_load_round`` writes, so a device call that raised after it ran is
run again from unchanged host state and writes the same rows and
tokens.  JAX donates its caches instead: a program that dies mid-run
deletes them and the JAX engine re-prefills every slot (``_cache_lost``
/ ``_rematerialize_cache``, where its host-tier spans serve the replay);
the port has nothing to rebuild, its prefill count does not move, and
its host spans stay in the trie for the next hit.  A sticky CUDA error
(an illegal address, a device assert) leaves the context unusable:
every later call raises, the breaker opens and every request retires
FAILED.  The tier and handoff counters are plain dicts in ``metrics()``
(``prefix_tiers``, ``handoff``); JAX's registry series and flight
events wait for the observability port.

Left out (ROADMAP Queue 1): tensor-parallel mesh and the draft's
replication over it (item 10), observability and tracing (item 9), the
``PT_KV_DTYPE`` and ``PT_PREFIX_HOST_BYTES`` flags.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..incubate.nn.kernels.flash_decode import SUPPORTED_HEAD_DIMS
from ..incubate.nn.kernels.fused_decode import KV_CHUNK
from ..incubate.nn.kv_quant import (byte_view, kv_components, kv_has_scales,
                                    kv_map, kv_storage_dtype, kv_zeros,
                                    resolve_kv_dtype)
from ..distributed import watchdog
from ..io import ByteCounter, device_put_async
from ..models import decoding, gpt, llama
from ..utils.retry import TRANSIENT_EXCS, RetryPolicy
from .lifecycle import (DRAIN_MODES, AdmissionQueue, CircuitBreaker,
                        CircuitOpenError, EngineClosedError, EngineState,
                        QueueFullError, RequestStatus, now as _now)
from .prefix_cache import (HostPagePayload, KVSpanPayload, PagePayload,
                           RadixPrefixCache, host_select, to_host)
from .programs import ProgramCache, resolve_capture

__all__ = ["ContinuousBatchingEngine", "PagedContinuousBatchingEngine",
           "FusedB1Engine", "Request", "RequestStatus", "EngineState",
           "QueueFullError", "CircuitOpenError", "EngineClosedError",
           "SpeculativeConfig"]


def _draft_family(name: str):
    """The model module of a draft family: its ``init_decode_cache``,
    ``decode_step_multi`` and ``prefill_into_slots`` are the draft-side
    programs."""
    if name == "llama":
        return llama
    if name != "gpt":
        raise ValueError(f"unknown draft model family {name!r}")
    return gpt


@dataclasses.dataclass
class SpeculativeConfig:
    """Draft-and-verify speculative decoding (the drafts propose
    greedily; the target's own greedy or sampled tokens are emitted).

    ``k`` — draft tokens proposed a scheduler round (the verify window is
    k+1 positions).  ``draft_params`` / ``draft_cfg`` — a small model of
    ``family`` ("gpt" or "llama") sharing the target's vocabulary, on
    the engine's device; its cache lives beside the target's, contiguous
    and in the engine's ``kv_dtype``.  With no draft model the host
    n-gram proposer (the ``ngram`` trailing tokens matched against the
    sequence's own history) guesses continuations, with no device
    launch."""
    k: int = 3
    draft_params: Any = None
    draft_cfg: Any = None
    family: str = "gpt"
    ngram: int = 2

    @property
    def has_model(self) -> bool:
        return self.draft_params is not None


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = RequestStatus.QUEUED
    deadline: Optional[float] = None   # monotonic; None = no deadline
    error: Optional[str] = None        # set with FAILED/TIMEOUT/REJECTED
    submitted_at: float = 0.0
    # monotonic stamps (None until reached); TTFT resolves at the host
    # sync that returned the first token, so a K-step decode loop stamps
    # all K tokens at once
    admitted_at: Optional[float] = None
    prefill_start: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # prompt tokens served from the prefix cache at the last admission
    prefix_hit: int = 0
    # of which came from the host tier (an asynchronous reinstall)
    prefix_host_hit: int = 0
    # set after a failed reinstall: the next admission plans from device
    # spans only (re-prefill, never a failed request); cleared at
    # admission
    no_host: bool = False
    # sampling seed: with engine temperature > 0, the token fed at
    # position p is drawn with key fold_in(PRNGKey(seed), p)
    seed: int = 0

    def seq_so_far(self) -> np.ndarray:
        """prompt + already-generated tokens — what a re-admission
        after a paged eviction must prefill."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    @property
    def terminal(self) -> bool:
        return self.status in RequestStatus.TERMINAL


def _derive_buckets(max_len: int) -> Tuple[int, ...]:
    """Prefill buckets for an engine: powers of two from 16 up to (and
    always including) ``max_len``."""
    out: List[int] = []
    b = 16
    while b < max_len:
        out.append(b)
        b <<= 1
    out.append(max_len)
    return tuple(out)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket")


@dataclasses.dataclass
class _AdmitPlan:
    """One admission's plan: the slot it targets, the sequence to
    admit, and the prefix cache's outcome — ``hit`` usable cached tokens
    and ``install`` the engine's install info (contiguous: the matched
    payload spans to copy; paged: the shared page ids, consumed when the
    pages are reserved, and the host pages' copy jobs).  ``solo``: a
    member of a batched prefill that failed, run again alone so that a
    poison pill is found.  ``hosted``: the install needs a host-tier
    reinstall, of ``host_tokens`` tokens."""
    slot: int
    req: Request
    seq: np.ndarray
    hit: int = 0
    install: Any = None
    solo: bool = False
    hosted: bool = False
    host_tokens: int = 0


@dataclasses.dataclass(eq=False)
class _InstallJob:
    """A reinstall in flight: the plan whose slot is reserved, the
    device tensors of each host payload (``xfer``, by payload id, in the
    engine's form), every tensor the copies fill and their events (None
    on the CPU), the start time, and the engine's decode seconds then
    (so completion reports how much decode overlapped the copy)."""
    plan: _AdmitPlan
    xfer: Dict[int, Any]
    tensors: List[torch.Tensor]
    events: List[Any]
    started: float
    decode_s0: float


def _span_rows(parts):
    """Token-axis (1) concatenation of span parts, each a tensor or an
    int8 ``(data, scale)`` pair: the components as byte views (fp8 rows
    are copied as their bytes)."""
    comps = [kv_components(p) for p in parts]
    return tuple(torch.cat([byte_view(c[i]) for c in comps], dim=1)
                 for i in range(len(comps[0])))


def _span_copy(x):
    """An owned copy of a cache slice (a tensor or a ``(data, scale)``
    pair): the payload survives later writes into the cache."""
    if isinstance(x, tuple):
        return tuple(_span_copy(c) for c in x)
    return byte_view(x).clone().view(x.dtype)


def _canonical_array(x: torch.Tensor) -> np.ndarray:
    """A cache tensor (device or host) as a host numpy array of its
    stored bytes: bf16 as its 16-bit words (numpy has no bfloat16 without
    ``ml_dtypes``), fp8 as its bytes, the rest as they are.  The bytes
    are what the JAX package's numpy arrays hold, so a span's SHA-256 is
    JAX's for the same K/V."""
    h = to_host(x) if x.is_cuda else x.contiguous()
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.uint16)
    if h.dtype == torch.float8_e4m3fn:
        return h.view(torch.uint8).numpy()
    return h.numpy()


def _host_tensor(arr: np.ndarray, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A canonical array back to a host tensor of ``dtype`` (the inverse
    of :func:`_canonical_array`), pinned for a CUDA engine.  Raises
    ValueError when the array's element type is not ``dtype``'s."""
    a = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(dtype)
    elif dtype == torch.float8_e4m3fn and a.dtype == np.uint8:
        t = torch.from_numpy(a).view(dtype)
    else:
        t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"span stored as {a.dtype}, the cache holds "
                         f"{dtype}")
    return t.pin_memory() if device.type == "cuda" else t.clone()


class ContinuousBatchingEngine:
    """Continuous-batching decoder for the GPT family.

    ``attn_kernel`` ("flash" default | "xla") — "flash" serves decode
    and prefill attention from the flash_decode kernel; "xla" runs the
    plain compositions.  ``kv_dtype`` ("bf16" default | "int8" |
    "fp8") — the KV cache's storage format; an explicit argument, since
    the JAX engine's ``PT_KV_DTYPE`` flag registry is not ported.
    ``device`` — CUDA unless ``"cpu"`` is passed; ``params`` must
    already lie there.  ``max_queue`` bounds the admission queue under
    the ``overload`` policy: "reject" (submit raises
    :class:`QueueFullError`), "shed-oldest" (the oldest queued request
    retires REJECTED) or "block" (submit runs scheduler iterations for
    up to ``overload_timeout`` seconds, then raises).  ``retry`` — the
    :class:`RetryPolicy` of every device call (default: 2 retries of
    ``OSError`` / ``TimeoutError``, backoff 0.05 s doubling to 1 s).
    ``step_timeout`` — seconds a device call may take before the
    watchdog's deadline raises ``TimeoutError`` (None: no deadline);
    warm the engine first, since a program's first runs build its
    kernels and capture its graph.  ``breaker_threshold`` consecutive
    failed calls open the circuit breaker (every request retires FAILED,
    submit raises :class:`CircuitOpenError` until ``reset_circuit()``);
    ``breaker_cooldown`` seconds later one submit rides through as the
    half-open probe.  ``prefill_budget`` — prompt tokens one scheduler
    iteration may prefill (None: unbounded; the first admission always
    runs).  ``max_stall_rounds`` — consecutive scheduler rounds without
    progress after which the stalled request retires FAILED with a
    capacity diagnostic (the livelock guard).  ``speculative`` — a
    :class:`SpeculativeConfig` (``True``: the n-gram proposer with
    k = 3) turns on draft-and-verify rounds; None or False, off.
    ``prefix_cache_bytes`` — byte budget of the radix prefix cache (0,
    the default: off; None: unbounded): admissions reuse the longest
    cached prefix of their sequence and fill only the suffix.
    ``prefix_host_bytes`` — byte budget of the prefix cache's host tier
    (0, the default: spans evicted from the device are dropped; None:
    unbounded): evicted spans are demoted to host memory and come back
    through the INSTALLING state (the module note).
    ``install_timeout`` — seconds a reinstall's copy may take before the
    request falls back to re-prefill.  ``temperature`` / ``top_k`` /
    ``top_p`` — engine-level sampling (the
    JAX engine's defaults 0.0 / 0 / 1.0): temperature <= 0 is greedy;
    else each request draws with its ``submit(seed=...)`` at each
    absolute position (the module note).  ``cuda_graphs`` — None (the
    default): the decode, verify and draft programs are captured as
    CUDA graphs on a CUDA engine and run eagerly on the CPU; False:
    eager on CUDA too; True: captured, and a CPU engine raises."""

    # the metrics()["launches"] key of an admission prefill
    _prefill_kind = "prefill"

    def __init__(self, params, cfg, max_batch: int = 4,
                 max_len: int = 1024, eos_token_id: Optional[int] = None,
                 max_queue: Optional[int] = None, overload: str = "reject",
                 overload_timeout: float = 5.0,
                 retry: Optional[RetryPolicy] = None,
                 step_timeout: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown: Optional[float] = None,
                 prefill_budget: Optional[int] = None,
                 attn_kernel: str = "flash", kv_dtype: str = "bf16",
                 max_stall_rounds: int = 8, speculative: Any = None,
                 prefix_cache_bytes: Optional[int] = 0,
                 prefix_host_bytes: Optional[int] = 0,
                 install_timeout: float = 30.0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, cuda_graphs: Optional[bool] = None,
                 device=None):
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"engine max_len={max_len} exceeds the model's "
                f"max_position_embeddings={cfg.max_position_embeddings}")
        if attn_kernel not in ("xla", "flash"):
            raise ValueError(
                f"attn_kernel must be 'xla' or 'flash', "
                f"got {attn_kernel!r}")
        self.device = resolve_device(device)
        where = params["wpe"].device
        if where.type != self.device.type:
            raise ValueError(f"params lie on {where}, the engine runs on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos = eos_token_id
        self.attn_kernel = attn_kernel
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.max_stall_rounds = int(max_stall_rounds)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._stall_rounds = 0
        self._stalls_total = 0
        # admissions sent back to the queue front because their capacity
        # could not be reserved (paged: the pool was short of pages)
        self._deferred = 0
        self._buckets = _derive_buckets(max_len)
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)     # pos being fed
        self._next_tok = np.zeros(max_batch, np.int32)
        # each slot's request seed (set at admission, loaded with the
        # round: no device write between a prefill and its round)
        self._seed = np.zeros(max_batch, np.int32)
        self._queue = AdmissionQueue(max_queue, overload)
        self.overload_timeout = float(overload_timeout)
        self._retry = retry if retry is not None else RetryPolicy(
            retries=2, backoff=0.05, max_backoff=1.0,
            retry_excs=TRANSIENT_EXCS)
        self.step_timeout = step_timeout
        self._breaker = CircuitBreaker(breaker_threshold,
                                       cooldown_seconds=breaker_cooldown)
        self.prefill_budget = (None if prefill_budget is None
                               else int(prefill_budget))
        self.state = EngineState.SERVING
        self._requests: Dict[int, Request] = {}
        self._pending_report: List[Request] = []
        self._next_rid = 0
        # device programs run, per kind ("prefill" / "decode")
        self._launch_counts: Dict[str, int] = {}
        # device-call attempts beyond the first, per funnel kind;
        # requests retired, per terminal status; quarantined admissions
        self._retries: Dict[str, int] = {}
        self._retired: Dict[str, int] = {}
        self._quarantined = 0
        self._decode_steps = 0
        # host clock around each decode loop, its one sync included
        self._decode_seconds = 0.0
        if speculative is True:
            speculative = SpeculativeConfig()
        elif speculative is False:
            speculative = None
        self._spec: Optional[SpeculativeConfig] = speculative
        # slot_launches = sum over rounds of launches x active slots: the
        # per-sequence denominator of tokens_per_launch
        self._spec_stats = {"proposed": 0, "accepted": 0, "emitted": 0,
                            "launches": 0, "slot_launches": 0,
                            "rollbacks": 0}
        self._draft_steps = 0
        if speculative is not None:
            self._check_speculative(speculative, cfg, max_len)
        # prompt tokens served from the prefix cache
        self._prefix_hit_tokens = 0
        if prefix_host_bytes is not None and prefix_host_bytes < 0:
            raise ValueError("prefix_host_bytes must be >= 0 or None")
        self.prefix_host_bytes = prefix_host_bytes
        self.install_timeout = float(install_timeout)
        self._installing: List[_InstallJob] = []
        # the host tier's counters: reinstalls, their seconds and the
        # decode seconds that overlapped them, bytes each way
        self._tier_stats = {"reinstalls": 0, "reinstall_failures": 0,
                            "host_hit_tokens": 0, "reinstall_seconds": 0.0,
                            "reinstall_decode_overlap_seconds": 0.0}
        self._h2d_bytes = ByteCounter()
        self._d2h_bytes = ByteCounter()
        # the side stream every reinstall copies on (decode never waits
        # on it)
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._handoff_stats = {"snapshots": 0, "restores": 0,
                               "carried_out": 0, "carried_in": 0,
                               "fallbacks": 0, "bytes_out": 0,
                               "bytes_in": 0, "spans_out": 0,
                               "spans_in": 0, "spans_bad": 0}
        self._prefix: Optional[RadixPrefixCache] = None
        if prefix_cache_bytes is None or prefix_cache_bytes > 0:
            self._prefix = RadixPrefixCache(
                prefix_cache_bytes, host_capacity_bytes=prefix_host_bytes,
                demoter=self._demote_payload, on_demote=self._on_demote)
        # the compiled programs and their static buffers: a round's fed
        # token, position, done flag and seed a slot (rows 0-3; the
        # seeds row is ``_seeds``), and the drafts a verify pass checks
        self._programs = ProgramCache(self.device, resolve_capture(
            cuda_graphs, self.device))
        self._io = torch.zeros((4, max_batch), dtype=torch.int32,
                               device=self.device)
        self._seeds = self._io[3]
        self._drafts = None
        if speculative is not None:
            self._drafts = torch.zeros((max_batch, speculative.k),
                                       dtype=torch.int32, device=self.device)
        self._init_cache()
        self._init_draft_cache()

    def _check_speculative(self, spec: SpeculativeConfig, cfg, max_len: int):
        if spec.k < 1:
            raise ValueError("speculative.k must be >= 1")
        _draft_family(spec.family)   # validate the name
        if not spec.has_model:
            return
        dcfg = spec.draft_cfg
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: draft proposals must be target token "
                "ids")
        if dcfg.max_position_embeddings < max_len:
            raise ValueError(
                f"draft max_position_embeddings="
                f"{dcfg.max_position_embeddings} cannot cover the "
                f"engine's max_len={max_len}")
        if self.attn_kernel == "flash" and self.device.type == "cuda" and \
                dcfg.head_dim not in SUPPORTED_HEAD_DIMS:
            # the CPU's plain flash_decode takes any head dim; the CUDA
            # kernel has instances for these only
            raise ValueError(
                f"draft head dim {dcfg.head_dim} is not one the flash_decode "
                f"CUDA kernel takes {SUPPORTED_HEAD_DIMS}; serve with "
                "attn_kernel='xla'")
        wte = spec.draft_params["wte"]
        where = (wte[0] if isinstance(wte, tuple) else wte).device
        if where.type != self.device.type:
            raise ValueError(f"draft params lie on {where}, the engine "
                             f"runs on {self.device}")

    # -- cache strategy (overridden by the paged engine) ---------------------
    def _init_cache(self):
        self._cache = gpt.init_decode_cache(self.cfg, self.max_batch,
                                            self.max_len, self.kv_dtype,
                                            device=self.device)

    def _reset_cache(self):
        """Replace the cache storage (and the draft cache) wholesale,
        dropping the programs that bind it.  Contiguous engines keep the
        prefix cache — its payloads are owned copies; the paged engine
        flushes its device spans first.  In-flight reinstalls target the
        old storage: they go back to the queue front (their host spans
        stay and serve the re-admission)."""
        requeue = []
        for job in list(self._installing):
            req = job.plan.req
            if not req.terminal:
                self._abort_install(job)
                req.status = RequestStatus.QUEUED
                requeue.append(req)
        self._requeue_front(requeue)
        self._programs.drop()
        self._init_cache()
        self._init_draft_cache()

    def _init_draft_cache(self):
        """The draft model's cache: contiguous ``[L, max_batch, max_len,
        ...]`` in the engine's ``kv_dtype`` whatever the target's layout
        (the draft is small), and for a LLaMA draft its rotary tables,
        built once.  A new draft cache drops the programs bound to the
        old one."""
        self._programs.drop()
        self._draft_cache = None
        self._draft_rope = None
        spec = self._spec
        if spec is None or not spec.has_model:
            return
        mod = _draft_family(spec.family)
        self._draft_cache = mod.init_decode_cache(
            spec.draft_cfg, self.max_batch, self.max_len, self.kv_dtype,
            device=self.device)
        if mod is llama:
            dcfg = spec.draft_cfg
            self._draft_rope = llama.rope_cos_sin(
                dcfg.max_position_embeddings, dcfg.head_dim,
                dcfg.rope_theta, spec.draft_params["wte"].dtype,
                self.device)

    def cache_bytes(self) -> int:
        """Device bytes held by the KV cache allocation, scale planes
        included."""
        return sum(c.numel() * c.element_size()
                   for c in self._cache.values())

    def _decode_step_fn(self):
        """The per-step decode (p, c, extra, tok, pos) -> (logits,
        cache): the one point where the contiguous and paged engines
        differ on the device side (``extra`` carries the paged engine's
        block tables; unused here)."""
        cfg, ak = self.cfg, self.attn_kernel

        def step(p, c, extra, tok, pos):
            del extra
            return gpt.decode_step_multi(p, c, tok, pos, cfg,
                                         attn_kernel=ak)

        return step

    def _verify_step_fn(self):
        """The speculative verify (p, c, extra, toks [B, W], pos) ->
        (logits [B, W, V], cache): the window analog of
        :meth:`_decode_step_fn`."""
        cfg, ak = self.cfg, self.attn_kernel

        def vstep(p, c, extra, toks, pos):
            del extra
            return gpt.verify_into_slots(p, c, toks, pos, cfg,
                                         attn_kernel=ak)

        return vstep

    def _decode_extra(self):
        """The extra device argument of the decode and verify steps: a
        static buffer, refilled by :meth:`_load_round` (paged: the block
        tables); None here."""
        return None

    def _load_round(self, state: np.ndarray):
        """Copy a round's host state into the programs' static buffers,
        outside any program: ``state`` [4, B] int32 (the token fed, the
        position fed, the done flag and the request's seed of each
        slot)."""
        self._io.copy_(torch.from_numpy(state))

    def _scan_clamp(self, active, max_tokens: int = 1) -> int:
        """Upper bound on the decode loop's length from cache headroom.
        Returns 0 when no active slot can advance (paged: after an
        eviction reshuffle)."""
        del max_tokens
        return min(self.max_len - 1 - int(self._pos[i]) for i in active)

    def _reserve_slot(self, plan: _AdmitPlan) -> bool:
        """Claim per-slot capacity before any device work (paged:
        pages; a prefix hit's shared pages go straight into the block
        table).  Returns False when the engine cannot host the request
        now."""
        return True

    def _release_slot(self, slot: int):
        """Free per-slot cache resources on retirement (paged: pages)."""

    def _stall_diagnostic(self, req: Request) -> str:
        return (f"request {req.rid} made no progress in "
                f"{self.max_stall_rounds} scheduler rounds "
                f"(sequence length {req.seq_so_far().size}, "
                f"max_len {self.max_len})")

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, max_new: int = 32, ttl: Optional[float] = None,
               deadline: Optional[float] = None, seed: int = 0) -> int:
        """Enqueue a generation request; returns its rid.

        ``ttl`` — seconds from now until the request expires (queued or
        mid-decode) with status TIMEOUT; ``deadline`` is the absolute
        monotonic-clock form (``ttl`` wins when both are given).
        ``seed`` (an int32) keys its draws when the engine samples.
        Raises :class:`QueueFullError` under overload (per the engine's
        policy), :class:`CircuitOpenError` while the breaker is open and
        :class:`EngineClosedError` after :meth:`drain`."""
        if self.state != EngineState.SERVING:
            raise EngineClosedError(
                f"engine is {self.state}; submissions are closed")
        if self._breaker.open and not self._breaker.should_probe():
            # after the cooldown ONE request rides through as the
            # recovery probe; until then new work is refused fast
            raise CircuitOpenError(self._breaker.reason)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.max_len:
            raise ValueError(
                f"prompt length {prompt.size} exceeds what the engine "
                f"can prefill (max_len={self.max_len})")
        if prompt.size + max_new > self.max_len:
            raise ValueError("prompt + max_new exceeds engine max_len")
        if not -2 ** 31 <= int(seed) < 2 ** 31:
            raise ValueError(f"seed {seed} is not an int32")
        if ttl is not None:
            deadline = _now() + ttl
        # the rid is used up before the offer, so a rejected request
        # (QueueFullError) still takes one, as in the JAX engine
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new, deadline=deadline,
                      submitted_at=_now(), seed=int(seed))
        self._offer(req)
        self._requests[req.rid] = req
        return req.rid

    def _offer(self, req: Request):
        """Admission control: the queue bound under the overload policy.
        ``block`` runs scheduler iterations (they free queue space as
        slots retire and re-admit) until space opens or
        ``overload_timeout`` expires."""
        if self._queue.policy == "block" and self._queue.full:
            give_up = _now() + self.overload_timeout
            while self._queue.full and self._has_work():
                if _now() >= give_up:
                    raise QueueFullError(
                        f"admission queue still full after blocking "
                        f"{self.overload_timeout}s "
                        f"({self._queue.context()})")
                self._step_inner(4)
        shed = self._queue.offer(req)
        if shed is not None:
            self._retire(shed, RequestStatus.REJECTED,
                         f"shed by overload policy 'shed-oldest' "
                         f"({self._queue.context()})")

    def run(self, steps_per_sync: int = 16) -> Dict[int, List[int]]:
        """Serve until the queue and every slot are empty; returns
        {rid: generated tokens}.

        Every request reaches a terminal status (the breaker, deadlines
        and the livelock guard bound every failure loop), so this
        returns under device faults too, then with partial token lists
        for requests that are not DONE: read ``status(rid)`` and
        ``request(rid).error``.  ``steps_per_sync``: tokens a scheduler
        iteration decodes on the device before it syncs with the host."""
        results: Dict[int, List[int]] = {}
        while self._has_work():
            for req in self.step(steps_per_sync):
                results[req.rid] = req.tokens
        # retirements made outside a step(): cancel, shed, the block
        # policy's iterations inside submit
        flush, self._pending_report = self._pending_report, []
        for req in flush:
            results[req.rid] = req.tokens
        return results

    def drain(self, timeout: Optional[float] = None,
              steps_per_sync: int = 16,
              mode: str = "retire") -> Dict[int, Request]:
        """Graceful shutdown: SERVING → DRAINING (submissions refused)
        → STOPPED; returns {rid: Request} of every request the engine
        knows.  ``mode="retire"`` finishes everything queued, installing
        or running, each reaching a terminal status; with ``timeout``,
        whatever is unfinished at the deadline retires TIMEOUT, so drain
        always returns, and no install job outlives DRAINING (a reinstall
        completes in the loop, falls back to re-prefill past
        ``install_timeout``, or retires at the deadline).
        ``mode="handoff"`` stops at a step boundary WITHOUT retiring:
        in-flight reinstalls go back to QUEUED, each running slot's rows
        so far are cached in the prefix cache and its request parked in
        the queue, still QUEUED, for ``inference.handoff`` to carry to a
        successor."""
        if mode not in DRAIN_MODES:
            raise ValueError(f"unknown drain mode {mode!r}; choose one "
                             f"of {DRAIN_MODES}")
        if mode == "handoff":
            return self._drain_handoff()
        if self.state == EngineState.SERVING:
            self.state = EngineState.DRAINING
        give_up = None if timeout is None else _now() + timeout
        while self._has_work():
            if give_up is not None and _now() >= give_up:
                self._retire_all(RequestStatus.TIMEOUT,
                                 f"engine drain timed out after "
                                 f"{timeout}s")
                break
            self._step_inner(steps_per_sync)
        self.state = EngineState.STOPPED
        self._pending_report = []
        return dict(self._requests)

    # -- live handoff hooks (inference.handoff drives them) ----------------
    def _drain_handoff(self) -> Dict[int, Request]:
        """The handoff drain: stop admissions at a step boundary and park
        every live request back in the queue.  In-flight reinstalls are
        aborted back to QUEUED first (their host spans stay); a running
        slot's prompt and emitted rows go into the prefix cache before
        its slot is freed (the span a DONE retirement would cache), so a
        warm successor skips their prefill.  Idempotent: on a stopped
        engine it returns the same request map."""
        if self.state == EngineState.SERVING:
            self.state = EngineState.DRAINING
        requeue: List[Request] = []
        for job in list(self._installing):
            req = job.plan.req
            if not req.terminal:
                self._abort_install(job)
                req.status = RequestStatus.QUEUED
                requeue.append(req)
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            seq = req.seq_so_far()
            if self._prefix is not None and seq.size > 1:
                self._insert_spans(seq[:seq.size - 1], i, extend=True)
            self._slot_req[i] = None
            self._release_slot(i)
            req.status = RequestStatus.QUEUED
            requeue.append(req)
        self._requeue_front(requeue)
        self.state = EngineState.STOPPED
        return dict(self._requests)

    def kv_storage_name(self) -> str:
        """The name of the cache's stored K/V dtype ("bfloat16",
        "float32", "int8", "float8_e4m3fn"): a handoff span record
        carries it beside its bytes."""
        return str(self._cache["k"].dtype).replace("torch.", "")

    def export_cache_spans(self):
        """The prefix cache span by span as canonical host records
        ``[(key, a, b, k, v), ...]``: numpy arrays in the layout
        ``[L, tokens, nH, hD]`` (int8: ``(data, scale)`` pairs, the
        scales ``[L, tokens, nH, 1]``), parents before children.  Each
        span goes through the funnel (kind "snapshot"), so the retry
        policy absorbs transients; a persistent failure propagates and
        fails the snapshot."""
        if self._prefix is None:
            return []
        out = []
        for key, a, b, payload in self._prefix.export_spans():
            rec = self._device_call("snapshot", self._span_to_canonical,
                                    payload, a, b)
            if rec is None:
                continue
            k, v, a2, b2 = rec
            out.append((key[:b2], a2, b2, k, v))
        return out

    def _span_to_canonical(self, payload, a: int, b: int):
        """One span as canonical host arrays: ``(k, v, a2, b2)``, the
        backed sub-range [a2, b2), or None when nothing is exportable.
        The contiguous layout is the canonical one; quantized spans
        export their stored bytes, never a dequantized copy."""
        return (kv_map(_canonical_array, payload.k),
                kv_map(_canonical_array, payload.v), a, b)

    def _canonical_to_payload(self, k, v, a: int, b: int):
        """A restored canonical record as a HOST-tier payload of this
        engine's layout: the reinstall path turns it back into device
        state at its first hit, so a restore touches no device memory."""
        del a, b
        return KVSpanPayload(self._from_canonical(k),
                             self._from_canonical(v), tier="host")

    def _from_canonical(self, x):
        """Canonical arrays (bf16 as 16-bit words, fp8 as bytes) back to
        host tensors of the cache's stored dtypes, pinned on a CUDA
        engine."""
        dtypes = (self._cache["k"].dtype, torch.float32)
        if isinstance(x, tuple):
            return tuple(_host_tensor(c, dt, self.device)
                         for c, dt in zip(x, dtypes))
        return _host_tensor(x, dtypes[0], self.device)

    def restore_requests(self, records) -> Tuple[List[Request],
                                                 List[Request],
                                                 Dict[int, int]]:
        """Re-admit carried requests from a verified bundle AHEAD of new
        traffic (queue front, their order kept).  Deadlines arrive as
        remaining TTL and are rebased onto this engine's clock; emitted
        tokens ride along, so the stream resumes at its recorded offset.
        A request this engine cannot host (longer than its ``max_len``)
        retires REJECTED with the reason.  Returns ``(restored,
        rejected, rid_map)``; ``rid_map`` maps the bundle's rids to this
        engine's (a fresh rid where the bundle's is taken)."""
        t = _now()
        restored: List[Request] = []
        rejected: List[Request] = []
        rid_map: Dict[int, int] = {}
        for rec in records:
            prompt = np.asarray(rec["prompt"], np.int32).reshape(-1)
            rid = int(rec["rid"])
            if rid in self._requests:
                rid = self._next_rid
            ttl = rec.get("remaining_ttl")
            req = Request(rid, prompt, int(rec["max_new"]),
                          tokens=[int(x) for x in rec["tokens"]],
                          deadline=None if ttl is None else t + float(ttl),
                          submitted_at=t, seed=int(rec.get("seed", 0)))
            self._next_rid = max(self._next_rid, req.rid + 1)
            self._requests[req.rid] = req
            rid_map[int(rec["rid"])] = req.rid
            seq_len = prompt.size + len(req.tokens)
            if seq_len > self.max_len or \
                    prompt.size + req.max_new > self.max_len:
                self._retire(req, RequestStatus.REJECTED,
                             f"carried request does not fit the successor "
                             f"engine (sequence {seq_len}, prompt+budget "
                             f"{prompt.size + req.max_new}, max_len "
                             f"{self.max_len})")
                rejected.append(req)
                continue
            restored.append(req)
        self._requeue_front(restored)
        self._handoff_stats["carried_in"] += len(restored)
        return restored, rejected, rid_map

    def step(self, max_tokens: int = 1) -> List[Request]:
        """Admit into free slots, advance every active slot up to
        ``max_tokens`` tokens, retire finished requests.  Returns the
        requests retired this iteration, each in a terminal status (DONE,
        or FAILED / TIMEOUT / CANCELLED / REJECTED when a robustness
        path retired it)."""
        self._step_inner(max_tokens)
        out, self._pending_report = self._pending_report, []
        return out

    def _step_inner(self, max_tokens: int):
        if self._breaker.open and not self._breaker.half_open:
            # the device is declared down: fail everything fast.  A
            # half-open probe runs a normal round, so that its outcome
            # closes or re-arms the breaker.
            self._retire_all(RequestStatus.FAILED, self._breaker.reason)
            return
        retired_before = len(self._pending_report)
        self._expire(_now())
        # finish the reinstalls whose copies have landed (outside every
        # program: an event query is not allowed inside a capture), then
        # admit
        self._poll_installs()
        self._admit()
        self._decode_round(max_tokens, retired_before)

    def status(self, rid: int) -> str:
        return self._requests[rid].status

    def request(self, rid: int) -> Request:
        return self._requests[rid]

    @property
    def circuit_open(self) -> bool:
        return self._breaker.open

    def reset_circuit(self):
        """Operator action: close the breaker once the device has
        recovered."""
        self._breaker.reset()

    def forget(self, rid: int) -> Optional[Request]:
        """Drop a TERMINAL request from the engine's bookkeeping (a
        long-lived server forgets reported requests, or the status map
        grows without bound); None if it is unknown or not terminal."""
        req = self._requests.get(rid)
        if req is not None and req.terminal:
            return self._requests.pop(rid)
        return None

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request: True when it moves to
        CANCELLED (its slot and pages are freed at once), False when it
        is unknown or already terminal."""
        req = self._requests.get(rid)
        if req is None or req.terminal:
            return False
        for i, r in enumerate(self._slot_req):
            if r is req:
                self._retire(req, RequestStatus.CANCELLED,
                             "cancelled by client", slot=i)
                return True
        for job in list(self._installing):
            if job.plan.req is req:
                # mid-reinstall: free the reserved slot (paged: pages)
                # before anything is installed; the copy's tensors are
                # dropped (the caching allocators keep their blocks
                # until the copy's stream has passed them)
                self._abort_install(job)
                self._retire(req, RequestStatus.CANCELLED,
                             "cancelled by client")
                return True
        try:
            self._queue.remove(req)
        except ValueError:
            return False
        self._retire(req, RequestStatus.CANCELLED, "cancelled by client")
        return True

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def metrics(self) -> Dict[str, Any]:
        """Scheduler snapshot: device programs per kind (``launches``:
        "prefill", "decode", and with speculation "verify", "draft" (a
        k-step proposal) and "draft_prefill"), decode and draft steps
        run, the host-clock seconds of the decode loops and speculative
        rounds, queue and slot gauges, the livelock guard's stalled
        rounds, deferred admissions, KV storage format and cache bytes,
        prompt tokens served from the prefix cache and spans it evicted;
        with the prefix cache on, ``prefix_cache``: the trie's stats; with
        speculation, ``speculative``: the JAX engine's counters.  The
        compiled programs: ``graphs`` ({"kind:steps": captured, runs,
        replays}), ``graph_replays``, ``capture_seconds`` and
        ``graph_pool_bytes`` (the reserved bytes the graphs' pool took,
        0 on the CPU).  Robustness: ``retries`` (device-call attempts
        beyond the first, by funnel kind), ``retired`` (requests by
        terminal status), ``quarantined`` admissions and ``breaker``
        (open, half-open, consecutive and total failures, opens, flaps,
        probes, last error).  The host tier: ``prefix_tiers`` (JAX's keys:
        the tiers' bytes, budgets and transitions, host hits, requests
        ``installing``, reinstalls and their failures, plus the summed
        reinstall seconds, the decode seconds that overlapped them and the
        bytes each way); the live handoff: ``handoff`` (JAX's
        counters)."""
        br = self._breaker
        out = {
            "attn_kernel": self.attn_kernel,
            "kv_dtype": self.kv_dtype,
            "launches": dict(self._launch_counts),
            "retries": dict(self._retries),
            "retired": dict(self._retired),
            "quarantined": self._quarantined,
            "breaker": {"open": br.open, "half_open": br.half_open,
                        "failures": br.failures,
                        "total_failures": br.total_failures,
                        "open_count": br.open_count,
                        "flaps_total": br.flaps_total, "probes": br.probes,
                        "last_error": br.last_error},
            "decode_steps": self._decode_steps,
            "draft_steps": self._draft_steps,
            "decode_seconds": self._decode_seconds,
            "active_slots": self.active_slots,
            "queued": self.queued,
            "queue_high_water": self._queue.high_water,
            "stalls": self._stalls_total,
            "deferred_admissions": self._deferred,
            "cache_bytes": self.cache_bytes(),
            "prefix_hit_tokens": self._prefix_hit_tokens,
            "prefix_evictions": (0 if self._prefix is None
                                 else self._prefix.evictions),
            **self._programs.metrics(),
        }
        out["handoff"] = dict(self._handoff_stats)
        if self._prefix is not None:
            p = self._prefix
            out["prefix_cache"] = p.stats()
            out["prefix_tiers"] = {
                "device_bytes": p.bytes,
                "device_capacity_bytes": p.capacity_bytes,
                "host_bytes": p.host_bytes,
                "host_capacity_bytes": p.host_capacity_bytes,
                "host_entries": p.host_entries,
                "demotions": p.demotions, "promotions": p.promotions,
                "host_evictions": p.host_evictions,
                "host_hits": p.host_hits,
                "host_hit_tokens": p.host_hit_tokens,
                "installing": len(self._installing),
                **self._tier_stats,
                "reinstall_bytes": self._h2d_bytes.value,
                "demote_bytes": self._d2h_bytes.value}
        if self._spec is not None:
            out["speculative"] = {
                "k": self._spec.k,
                "draft": (self._spec.family if self._spec.has_model
                          else "ngram"),
                **self._spec_stats,
                "accept_ratio": self._spec_accept_ratio(),
                "tokens_per_launch": self._spec_tokens_per_launch(),
            }
        return out

    def _spec_accept_ratio(self) -> Optional[float]:
        """Accepted / proposed draft tokens (None before a speculative
        round)."""
        if self._spec is None or not self._spec_stats["proposed"]:
            return None
        return self._spec_stats["accepted"] / self._spec_stats["proposed"]

    def _spec_tokens_per_launch(self) -> Optional[float]:
        """Tokens emitted per device launch per active slot over the
        speculative rounds: (1 + k * accept) / 2 for a model draft (two
        launches a round), 1 + k * accept for n-gram."""
        if self._spec is None or not self._spec_stats["slot_launches"]:
            return None
        return self._spec_stats["emitted"] / self._spec_stats["slot_launches"]

    # -- scheduler ---------------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self._queue) or self.active_slots > 0 or any(
            not j.plan.req.terminal for j in self._installing)

    def _bucket(self, n: int) -> int:
        return _bucket(n, self._buckets)

    def _note_launch(self, kind: str):
        self._launch_counts[kind] = self._launch_counts.get(kind, 0) + 1

    def _requeue_front(self, reqs: Sequence[Request]):
        """Back to the queue FRONT preserving FIFO order (extendleft
        reverses its argument)."""
        if reqs:
            self._queue.extendleft(reversed(list(reqs)))

    def _admit(self):
        """Fill free slots in slot order from the queue head (expired
        heads retire TIMEOUT on the way), within ``prefill_budget``, plan
        each admission against the prefix cache, reserve their capacity
        (whatever the pool cannot back yet goes back to the queue front,
        FIFO), then run them: every same-bucket group of this round's
        misses in one prefill, each hit as an install plus its suffix."""
        t = _now()
        plans: List[_AdmitPlan] = []
        busy = {job.plan.slot for job in self._installing
                if not job.plan.req.terminal}
        spent = 0
        for slot in range(self.max_batch):
            if self._slot_req[slot] is not None or slot in busy:
                continue
            req = self._next_admissible(t)
            if req is None:
                break
            plan = self._plan_admission(slot, req)
            # the prefill budget: tokens the device must prefill or fill
            # for this plan (a host-tier copy is free here: it overlaps
            # decode, not prefill); the FIRST admission always proceeds
            cost = max(plan.seq.size - 1 - plan.hit, 0)
            if self.prefill_budget is not None and plans \
                    and spent + cost > self.prefill_budget:
                self._requeue_front([req])
                break
            spent += cost
            req.prefill_start = _now()
            plans.append(plan)
        ready = []
        for idx, plan in enumerate(plans):
            if self._reserve_slot(plan):
                ready.append(plan)
            else:
                self._requeue_front([p.req for p in plans[idx:]])
                self._deferred += len(plans) - idx
                break
        self._run_admission(ready)

    def _next_admissible(self, t: float) -> Optional[Request]:
        """Pop the next queue head that has not expired (expired heads
        retire TIMEOUT in place)."""
        while self._queue:
            req = self._queue[0]
            if req.deadline is not None and t >= req.deadline:
                self._queue.popleft()
                self._retire(req, RequestStatus.TIMEOUT,
                             f"deadline expired after "
                             f"{t - req.submitted_at:.3f}s in queue")
                continue
            return self._queue.popleft()
        return None

    def _plan_admission(self, slot: int, req: Request) -> _AdmitPlan:
        plan = _AdmitPlan(slot=slot, req=req, seq=req.seq_so_far())
        S = plan.seq.size
        if self._prefix is not None and S > 1:
            # only rows [0, S-1) are needed: priming recomputes the last
            # position's K/V on the first decode step
            length, spans = self._prefix.match(plan.seq[:S - 1])
            if req.no_host:
                # a reinstall for this request failed: plan from the
                # device spans before the first host span (re-prefill)
                kept, n = [], 0
                for payload, m in spans:
                    if payload.tier == "host":
                        break
                    kept.append((payload, m))
                    n += m
                length, spans = n, kept
            plan.hit, plan.install = self._prefix_usable(length, spans,
                                                         S - 1)
            plan.hosted, plan.host_tokens = self._install_host_info(plan)
        return plan

    def _install_host_info(self, plan: _AdmitPlan) -> Tuple[bool, int]:
        """(needs a reinstall, host tokens) of a planned install —
        contiguous layout: the install's tokens that lie on host
        payloads."""
        if not plan.hit or plan.install is None:
            return False, 0
        got = htok = 0
        for payload, m in plan.install:
            take = min(m, plan.hit - got)
            if take <= 0:
                break
            if payload.tier == "host":
                htok += take
            got += take
        return htok > 0, htok

    def _prefix_usable(self, length: int, spans, cap: int):
        """How many matched tokens this engine can install, and the
        install info.  Contiguous: every matched token (payload rows
        copy at token granularity)."""
        P = min(length, cap)
        return (P, spans) if P > 0 else (0, None)

    def _run_admission(self, plans: Sequence[_AdmitPlan]):
        """Run the admission calls in plan order: a miss takes every
        later miss of its bucket into one prefill (``_prefill_into`` for
        one, ``_prefill_batch`` for several); a hit runs alone; then the
        model draft's prefill of the group.  The poison-pill guard: a
        batch that fails after its retries runs again one member at a
        time, and a member that fails alone retires FAILED
        (quarantined), its capacity released, while the breaker judges
        the device; the rest of the round goes on."""
        work = deque(plans)
        while work:
            head = work.popleft()
            group = [head]
            if not head.hit and not head.solo:
                b = self._bucket(head.seq.size)
                for p in [p for p in work if not p.hit and not p.solo
                          and self._bucket(p.seq.size) == b]:
                    group.append(p)
                    work.remove(p)
            if head.hosted:
                # a host-tier hit: start the asynchronous copy and park
                # the request INSTALLING; its install, suffix and draft
                # prefill run in a later step once the copy has landed
                self._begin_install(head)
                continue
            try:
                if head.hit:
                    self._admit_hit(head)
                else:
                    if len(group) == 1:
                        self._device_call("prefill", self._prefill_into,
                                          head.slot, head.req)
                    else:
                        self._device_call("prefill", self._prefill_batch,
                                          tuple(p.slot for p in group),
                                          tuple(p.req for p in group))
                    self._note_launch(self._prefill_kind)
                if self._draft_cache is not None:
                    # the draft must cover the admitted sequences before
                    # it can propose (it has no prefix cache)
                    self._device_call("draft", self._draft_prefill,
                                      tuple(p.slot for p in group),
                                      tuple(p.req for p in group))
                    self._note_launch("draft_prefill")
            except Exception as e:  # noqa: BLE001 — the poison-pill guard
                if len(group) > 1:
                    for p in group:
                        p.solo = True
                    work.extendleft(reversed(group))
                    continue
                plan = group[0]
                self._release_slot(plan.slot)
                self._quarantined += 1
                self._retire(plan.req, RequestStatus.FAILED,
                             f"prefill failed after retries: {e!r}")
                if self._breaker.record_failure(e):
                    for p in work:
                        self._release_slot(p.slot)
                    self._requeue_front([p.req for p in work])
                    self._retire_all(RequestStatus.FAILED,
                                     self._breaker.reason)
                    return
                continue
            self._breaker.record_success()
            for p in group:
                self._finish_admit(p)

    def _prefill_into(self, slot: int, req: Request):
        """Prefill one request's sequence so far into ``slot`` (the
        one-request case of :meth:`_prefill_batch`, kept as its own call
        so that a fault can target one request)."""
        self._prefill_batch((slot,), (req,))

    def _prefill_batch(self, slots: Sequence[int],
                       reqs: Sequence[Request]):
        """One prefill of a bucket's sequences straight into their
        slots."""
        seqs = [r.seq_so_far() for r in reqs]
        bucket = self._bucket(max(s.size for s in seqs))
        ids = np.zeros((len(seqs), bucket), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :s.size] = s
        with torch.inference_mode():
            gpt.prefill_into_slots(
                self.params, torch.from_numpy(ids).to(self.device),
                self.cfg, self._cache,
                torch.tensor(slots, dtype=torch.long, device=self.device),
                attn_kernel=self.attn_kernel)

    def _draft_prefill(self, slots: Sequence[int],
                       reqs: Sequence[Request]):
        """Bring the draft cache up to date for (re-)admitted slots in ONE
        batched prefill of the full sequences so far, bucketed: the draft
        has no prefix cache, and this keeps its state at the target's
        slot positions."""
        spec = self._spec
        mod = _draft_family(spec.family)
        seqs = [r.seq_so_far() for r in reqs]
        ids = np.zeros((len(seqs), self._bucket(max(s.size for s in seqs))),
                       np.int32)
        for i, s in enumerate(seqs):
            ids[i, :s.size] = s
        with torch.inference_mode():
            mod.prefill_into_slots(
                spec.draft_params, torch.from_numpy(ids).to(self.device),
                spec.draft_cfg, self._draft_cache,
                torch.tensor(slots, dtype=torch.long, device=self.device),
                attn_kernel=self.attn_kernel)

    def _finish_admit(self, plan: _AdmitPlan):
        slot, req, seq = plan.slot, plan.req, plan.seq
        self._slot_req[slot] = req
        req.status = RequestStatus.RUNNING
        req.admitted_at = _now()
        req.prefix_hit = plan.hit
        req.prefix_host_hit = plan.host_tokens
        req.no_host = False   # a fresh reinstall may serve re-admission
        self._prefix_hit_tokens += plan.hit
        self._tier_stats["host_hit_tokens"] += plan.host_tokens
        # prime: feed the last REAL token at pos len-1 — the next decode
        # step's argmax continues the sequence (for a fresh request that
        # is generated token #1; after an eviction the next unconsumed
        # token)
        self._pos[slot] = seq.size - 1
        self._next_tok[slot] = int(seq[-1])
        self._seed[slot] = req.seed
        if self._prefix is not None and seq.size > 1:
            self._prefix_insert(plan)

    # -- prefix-cache hooks (contiguous layout; paged/fused override) --------
    def _admit_hit(self, plan: _AdmitPlan):
        """Install the cached prefix into the slot, then fill the
        unmatched suffix through the engine's own decode block.  A full
        hit (P == S-1) runs no suffix pass — and for the paged engine
        not even an install (the block table already holds the shared
        pages)."""
        if plan.install is not None:
            self._device_call("prefix", self._install_prefix, plan)
            self._note_launch("prefix")
        suffix = plan.seq[plan.hit:plan.seq.size - 1]
        if suffix.size:
            with torch.inference_mode():
                self._device_call("prefix", self._suffix_fill, plan.slot,
                                  suffix, plan.hit)
            self._note_launch("prefix")

    # -- host-tier reinstall (the INSTALLING path) ---------------------------
    def _begin_install(self, plan: _AdmitPlan):
        """Start a host-tier reinstall: the plan's copies (funnel kind
        "reinstall"), then the request is INSTALLING.  A start that fails
        after its retries sends the request back to re-prefill."""
        req = plan.req
        try:
            xfer, tensors, events = self._device_call(
                "reinstall", self._start_reinstall, plan)
        except Exception as e:  # noqa: BLE001 — the tier's fallback
            self._reinstall_failed(plan, e)
            return
        req.status = RequestStatus.INSTALLING
        self._installing.append(_InstallJob(plan, xfer, tensors, events,
                                            _now(), self._decode_seconds))

    def _put(self, x: torch.Tensor, tensors: List[torch.Tensor],
             events: List[Any]) -> torch.Tensor:
        """One reinstall copy of host tensor ``x`` on the side stream,
        its tensor and event kept for the poll.  Every host payload of a
        CUDA engine is contiguous and pinned (``to_host``, the host
        splits, ``_host_tensor``), as ``device_put_async`` requires."""
        t, ev = device_put_async(x, self.device, self._h2d_stream,
                                 self._h2d_bytes)
        tensors.append(t)
        events.append(ev)
        return t

    def _start_reinstall(self, plan: _AdmitPlan):
        """The copies of a hosted plan (contiguous layout): one
        asynchronous copy a host tensor of each host payload.  Returns
        (xfer, tensors, events)."""
        xfer: Dict[int, Any] = {}
        tensors: List[torch.Tensor] = []
        events: List[Any] = []
        for payload, _m in plan.install:
            if payload.tier != "host":
                continue
            k = kv_map(lambda x: self._put(x, tensors, events), payload.k)
            v = kv_map(lambda x: self._put(x, tensors, events), payload.v)
            xfer[id(payload)] = (payload, k, v)
        return xfer, tensors, events

    def _install_ready(self, job: _InstallJob) -> bool:
        """Whether a reinstall's copies have landed, without blocking
        (``Event.query()``; the CPU's copies are done at once).  The
        decode rounds go on until this turns true."""
        return all(ev is None or ev.query() for ev in job.events)

    def _poll_installs(self):
        """Finish the reinstalls whose copies have landed: install and
        fill the suffix (and the draft's prefill), promote the spans back
        to the device tier and hand the slot to the decode rounds.
        Copies still in flight stay parked; one older than
        ``install_timeout`` falls back to re-prefill."""
        if not self._installing:
            return
        jobs, self._installing = self._installing, []
        for job in jobs:
            plan, req = job.plan, job.plan.req
            if req.terminal:
                continue     # cancel or TTL released the slot already
            if not self._install_ready(job):
                if _now() - job.started > self.install_timeout:
                    self._reinstall_failed(plan, TimeoutError(
                        f"reinstall copy not ready after "
                        f"{self.install_timeout}s"))
                else:
                    self._installing.append(job)
                continue
            try:
                self._device_call("reinstall", self._complete_reinstall,
                                  job)
                self._note_launch("reinstall")
                if self._draft_cache is not None:
                    self._device_call("draft", self._draft_prefill,
                                      (plan.slot,), (req,))
                    self._note_launch("draft_prefill")
            except Exception as e:  # noqa: BLE001 — the isolation boundary
                self._reinstall_failed(plan, e)
                continue
            self._breaker.record_success()
            self._promote_installed(job)
            self._finish_admit(plan)
            st = self._tier_stats
            st["reinstalls"] += 1
            st["reinstall_seconds"] += _now() - job.started
            st["reinstall_decode_overlap_seconds"] += \
                self._decode_seconds - job.decode_s0

    def _consume_copies(self, job: _InstallJob):
        """Order a job's copies before the current stream's reads: wait
        on their events, and mark their tensors (allocated on the side
        stream) as used on this one, so the allocator does not hand
        their blocks back before this stream's work on them is done."""
        if self.device.type != "cuda":
            return
        cur = torch.cuda.current_stream(self.device)
        for ev in job.events:
            cur.wait_event(ev)
        for t in job.tensors:
            t.record_stream(cur)

    def _complete_reinstall(self, job: _InstallJob):
        """Install the copied prefix into the slot (in place) and fill the
        suffix: a hosted ``_admit_hit``, run only once the copies have
        landed."""
        plan = job.plan
        self._consume_copies(job)
        resolved = []
        for payload, m in plan.install:
            part = job.xfer.get(id(payload))
            if part is not None:
                _p, k, v = part
                resolved.append((KVSpanPayload(k, v, payload.token_axis), m))
            else:
                resolved.append((payload, m))
        with torch.inference_mode():
            self._install_prefix(plan, resolved)
            self._fill_reinstalled_suffix(plan)

    def _fill_reinstalled_suffix(self, plan: _AdmitPlan):
        suffix = plan.seq[plan.hit:plan.seq.size - 1]
        if suffix.size:
            self._suffix_fill(plan.slot, suffix, plan.hit)

    def _promote_installed(self, job: _InstallJob):
        """Swap the reinstalled host spans for device payloads in place,
        so the next hit is a device hit (contiguous: the copied tensors
        become the payload)."""
        for payload, k, v in job.xfer.values():
            self._prefix.promote(payload,
                                 KVSpanPayload(k, v, payload.token_axis))

    def _reinstall_failed(self, plan: _AdmitPlan, err: BaseException,
                          no_host: bool = True):
        """The tier's fallback: release the reservation and send the
        request to the queue FRONT, to re-prefill (planning from device
        spans only with ``no_host``) instead of failing.  Faults below
        the retry budget never reach here."""
        del err
        req = plan.req
        self._release_slot(plan.slot)
        req.status = RequestStatus.QUEUED
        req.no_host = no_host
        self._requeue_front([req])
        self._tier_stats["reinstall_failures"] += 1

    def _abort_install(self, job: _InstallJob):
        """Drop an in-flight reinstall (cancel, TTL, drains): free the
        reserved slot and forget the job.  Nothing was installed yet;
        the copy's tensors are dropped (the device block stays on the
        side stream's pool until the stream has passed the copy, the
        pinned source in the caching host allocator until the copy's
        event has completed)."""
        if job in self._installing:
            self._installing.remove(job)
        self._release_slot(job.plan.slot)

    def _await_install(self):
        """No slot decodes and a reinstall is in flight: block on the
        oldest copy (nothing exists for it to overlap), through the
        funnel (kind "reinstall"); a failure is left to the poll."""
        jobs = [j for j in self._installing if not j.plan.req.terminal]
        if not jobs:
            return
        oldest = min(jobs, key=lambda j: j.started)
        try:
            self._device_call("reinstall", self._wait_copies, oldest)
        except Exception:  # noqa: BLE001 — the poll reports the error
            pass

    @staticmethod
    def _wait_copies(job: _InstallJob):
        for ev in job.events:
            if ev is not None:
                ev.synchronize()

    # -- tier demotion (a device-budget eviction to host memory) -------------
    def _demote_payload(self, payload):
        """The prefix cache's demoter: one blocking copy to host memory a
        span, through the funnel (kind "demote").  It runs on the insert
        and eviction path only, never inside a decode round."""
        return self._device_call("demote", payload.demote)

    def _on_demote(self, host_payload):
        self._d2h_bytes.inc(host_payload.nbytes)

    def _read_span(self, slot: int, a: int, b: int) -> KVSpanPayload:
        """Copy K/V rows [a, b) of ``slot`` out of the cache (the payload
        of a prefix-cache insert); int8 caches copy the scale rows
        beside the data as ``(data, scale)`` pairs."""
        c = self._cache
        k, v = c["k"][:, slot, a:b], c["v"][:, slot, a:b]
        if "ks" in c:
            k = (k, c["ks"][:, slot, a:b])
            v = (v, c["vs"][:, slot, a:b])
        return KVSpanPayload(_span_copy(k), _span_copy(v))

    @staticmethod
    def _write_span_update(cache, k, v, slot):
        """Write span rows [0, P) into ``slot`` in place: k, v the
        components of :func:`_span_rows` (data bytes, then the int8
        scales)."""
        for name, comps in (("k", k), ("v", v)):
            P = comps[0].shape[1]
            byte_view(cache[name])[:, slot, :P] = comps[0]
            if len(comps) > 1:
                cache[name + "s"][:, slot, :P] = comps[1]

    def _install_prefix(self, plan: _AdmitPlan, spans=None):
        """Concatenate the matched payload spans and write rows [0, P)
        into the slot, in place.  ``spans`` overrides ``plan.install`` on
        the reinstall path (host payloads resolved to device tensors)."""
        P = plan.hit
        parts_k, parts_v, got = [], [], 0
        for payload, m in (plan.install if spans is None else spans):
            take = min(m, P - got)
            if take <= 0:
                break
            k, v = payload.take(take)
            parts_k.append(k)
            parts_v.append(v)
            got += take
        with torch.inference_mode():
            self._write_span_update(self._cache, _span_rows(parts_k),
                                    _span_rows(parts_v), plan.slot)

    def _suffix_fill(self, slot: int, tokens: np.ndarray, start: int):
        """Feed ``tokens`` at positions [start, start + n) of ``slot`` in
        ONE windowed pass of the decode block (``verify_into_slots`` on
        the slot's view of the cache, W = n, no head): the K/V land
        where n decode steps would write them, and the flash_decode
        kernel serves the window's attention (the chunked-prefill use
        of it; its instances tile any W)."""
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int32)
                                [None]).to(self.device)
        pos = torch.tensor([start], dtype=torch.int32, device=self.device)
        view = {name: a[:, slot:slot + 1] for name, a in self._cache.items()}
        gpt.verify_into_slots(self.params, view, toks, pos, self.cfg,
                              attn_kernel=self.attn_kernel, logits=False)

    def _prefix_insert(self, plan: _AdmitPlan):
        """Cache the freshly written K/V of the sequence minus its last
        token (that row is only written by the first decode step)."""
        self._insert_spans(plan.seq[:plan.seq.size - 1], plan.slot)

    def _prefix_extend(self, req: Request, slot: int):
        """DONE retirement: extend the cached prefix with the request's
        emitted output, so a request continuing this conversation skips
        the generated span too."""
        seq = req.seq_so_far()
        self._insert_spans(seq[:seq.size - 1], slot, extend=True)

    def _insert_spans(self, key: np.ndarray, slot: int,
                      extend: bool = False):
        """Insert ``key``'s uncovered tail into the trie, its K/V read
        from ``slot`` (engine-layout specific, :meth:`_read_span`)."""
        self._prefix.insert(key, lambda a, b: self._read_span(slot, a, b),
                            extend=extend)

    def _decode_many(self, K: int, state: np.ndarray) -> np.ndarray:
        """The K-step decode program over the round ``state`` (see
        :meth:`_load_round`): K decode steps on the device, each drawing
        its token (greedy, or the position-keyed sampler with the slots'
        seeds); one host sync at the end.  Returns tokens [K, B]."""
        toks = self._device_call("decode", self._decode_run, K, state)
        self._note_launch("decode")
        self._decode_steps += K
        return toks

    def _decode_run(self, K: int, state: np.ndarray) -> np.ndarray:
        """The funnelled decode call: load the round, run the K-step
        program, read its tokens back.  Both copies wait for the device,
        so the call's deadline covers the work queued before it and the
        round itself."""
        self._load_round(state)
        prog = self._programs.get("decode", K, lambda: self._decode_body(K))
        prog.run()
        return prog.outputs["out"].cpu().numpy()

    def _decode_body(self, K: int):
        """The body of the K-step decode program (JAX's
        ``_decode_k_program``) and its output buffer [K, B].  Done
        slots keep their position (their writes land on a row they own,
        or on a junk row) and feed the eos id."""
        eos = -1 if self.eos is None else self.eos
        step_fn = self._decode_step_fn()
        extra = self._decode_extra()
        io = self._io
        out = torch.zeros((K, self.max_batch), dtype=torch.int32,
                          device=self.device)

        def body():
            tok, pos, done = io[0], io[1], io[2] != 0
            with torch.inference_mode():
                for s in range(K):
                    logits, _ = step_fn(self.params, self._cache, extra, tok,
                                        pos)
                    nxt = decoding.sample_token_pos(
                        logits, self._seeds, pos, self.temperature,
                        self.top_k, self.top_p)
                    nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                    done = done | (nxt == eos)
                    pos = torch.where(done, pos, pos + 1)
                    tok = nxt
                    out[s] = nxt

        return body, {"out": out}

    def _propose(self, k: int, state: np.ndarray):
        """The draft program over the round ``state``: k greedy draft
        steps on the device into the static drafts buffer, no readback."""
        self._device_call("draft", self._propose_run, k, state)
        self._note_launch("draft")
        self._draft_steps += k

    def _propose_run(self, k: int, state: np.ndarray):
        """The funnelled draft call: load the round (a copy that waits
        for the work queued before it), run the draft program."""
        self._load_round(state)
        self._programs.get("draft", k, lambda: self._propose_body(k)).run()

    def _propose_body(self, k: int):
        """The body of the draft program (JAX's ``_propose_k_program``):
        drafts [:, :k] from the loaded round's tokens and positions.
        Inactive slots ride along pinned at the junk row ``max_len - 1``
        (JAX lets them run on and drops the writes past the cache; a
        torch index there raises); an active slot's k - 1 steps stay
        below it (k < its headroom)."""
        spec = self._spec
        mod = _draft_family(spec.family)
        kw = {} if self._draft_rope is None else \
            {"rope_tables": self._draft_rope}
        last = self.max_len - 1
        io, drafts = self._io, self._drafts

        def body():
            tok, pos = io[0], io[1]
            with torch.inference_mode():
                for j in range(k):
                    logits, _ = mod.decode_step_multi(
                        spec.draft_params, self._draft_cache, tok, pos,
                        spec.draft_cfg, attn_kernel=self.attn_kernel, **kw)
                    tok = torch.argmax(logits, dim=-1).to(torch.int32)
                    drafts[:, j] = tok
                    pos = torch.clamp(pos + 1, max=last)

        return body, {}

    def _verify_many(self, k: int, state: Optional[np.ndarray] = None,
                     drafts: Optional[np.ndarray] = None) -> np.ndarray:
        """The verify program over the round and drafts [:, :k]: returns
        its output [2, B, k + 1] read back to the host, the fed window and
        the target tokens.  ``state`` / ``drafts``: the round and the
        n-gram drafts to load first (None: a draft call loaded the round
        and wrote the drafts)."""
        out = self._device_call("verify", self._verify_run, k, state, drafts)
        self._note_launch("verify")
        return out

    def _verify_run(self, k: int, state: Optional[np.ndarray],
                    drafts: Optional[np.ndarray]) -> np.ndarray:
        """The funnelled verify call: load what is given, run the verify
        program, read its output back (so a stalled verify trips this
        call's deadline)."""
        if state is not None:
            self._load_round(state)
        if drafts is not None:
            self._drafts[:, :k].copy_(torch.from_numpy(drafts))
        prog = self._programs.get("verify", k, lambda: self._verify_body(k))
        prog.run()
        return prog.outputs["out"].cpu().numpy()

    def _verify_body(self, k: int):
        """The body of the verify program (JAX's ``_verify_program``):
        ONE pass of the target over each slot's window [tok, drafts...]
        and the target's token at every position (greedy, or the sampler
        at that absolute position)."""
        vstep = self._verify_step_fn()
        extra = self._decode_extra()
        io, drafts = self._io, self._drafts
        out = torch.zeros((2, self.max_batch, k + 1), dtype=torch.int32,
                          device=self.device)

        def body():
            tok, pos = io[0], io[1]
            with torch.inference_mode():
                toks = torch.cat([tok[:, None], drafts[:, :k]], dim=1)
                logits, _ = vstep(self.params, self._cache, extra, toks, pos)
                out[0] = toks
                out[1] = decoding.sample_window(
                    logits, self._seeds, pos, self.temperature, self.top_k,
                    self.top_p)

        return body, {"out": out}

    def _decode_round(self, max_tokens: int, retired_before: int):
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            if self._installing:
                # nothing decodes: the only progress is a reinstall in
                # flight, and waiting for it overlaps nothing
                self._await_install()
                return
            # capacity-blocked admission with nothing running: only a
            # round that retired nothing counts toward the livelock guard
            if self._queue and len(self._pending_report) == retired_before:
                self._note_stall()
            return
        want = max_tokens if self._spec is None \
            else max(max_tokens, self._spec.k + 1)
        clamp = self._scan_clamp(active, want)
        if clamp < 1:
            # nobody can advance this iteration (paged eviction just
            # reshuffled); the next step() re-admits and retries —
            # unless this evict -> re-admit cycle is a livelock
            self._note_stall()
            return
        # _scan_clamp may have EVICTED slots (paged): refresh the view
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if self._spec is not None and clamp >= 2:
            # draft + one verify pass; near the cache lip (clamp < 2: no
            # row for even one draft token) the plain loop runs instead
            self._spec_round(active, clamp)
            return
        # K bounded by headroom, rounded down to a power of two; slots
        # whose budget runs out mid-loop retire at the boundary and the
        # host drops their overshoot
        K = max(1, min(max_tokens, clamp))
        K = 1 << (K.bit_length() - 1)
        t_scan = _now()
        try:
            toks = self._decode_many(K, self._round_state())
        except Exception as e:  # noqa: BLE001 — the isolation boundary
            self._decode_failure(e)
            return
        self._breaker.record_success()
        t_host = _now()
        self._decode_seconds += t_host - t_scan
        self._stall_rounds = 0    # tokens produced: not a livelock
        for i in active:
            req = self._slot_req[i]
            for new in toks[:, i]:
                if req.done:
                    break
                req.tokens.append(int(new))
                self._pos[i] += 1
                if len(req.tokens) == 1:
                    req.first_token_at = t_host
                if len(req.tokens) >= req.max_new or int(new) == self.eos:
                    req.done = True
            if req.done:
                self._retire(req, RequestStatus.DONE, slot=i)
            else:
                self._next_tok[i] = int(toks[-1, i])

    def _spec_round(self, active: List[int], clamp: int):
        """One draft-and-verify round: propose k tokens a slot (a draft
        model: one launch sequence; n-gram: on the host), verify the k+1
        positions of every slot in ONE pass, read the fed window and the
        target tokens back in ONE host sync, and emit each slot's
        accepted prefix plus the target's own next token.  Every emitted
        token is the target's, so the stream equals the non-speculative
        one; acceptance decides only how many land a round."""
        spec = self._spec
        k = min(spec.k, clamp - 1)
        launches = 1                                  # the verify
        t_scan = _now()
        state = self._round_state()
        try:
            if spec.has_model:
                self._propose(k, state)
                launches += 1
                feed, g = self._verify_many(k)
            else:
                feed, g = self._verify_many(k, state,
                                            self._ngram_proposals(k))
        except Exception as e:  # noqa: BLE001 — the isolation boundary
            self._decode_failure(e)
            return
        self._breaker.record_success()
        t_host = _now()
        self._decode_seconds += t_host - t_scan
        self._stall_rounds = 0
        delivered = accepted = rollbacks = 0
        for i in active:
            req = self._slot_req[i]
            for j in range(k + 1):
                if j > 0 and feed[i, j] != g[i, j - 1]:
                    # the draft left the target at window slot j: g[i, j]
                    # saw a wrong context; the correction g[i, j - 1] is
                    # already emitted
                    rollbacks += 1
                    break
                if req.done:
                    break
                new = int(g[i, j])
                if j > 0:
                    accepted += 1
                req.tokens.append(new)
                delivered += 1
                self._pos[i] += 1
                self._next_tok[i] = new
                if len(req.tokens) == 1:
                    req.first_token_at = t_host
                if len(req.tokens) >= req.max_new or new == self.eos:
                    req.done = True
            if req.done:
                self._retire(req, RequestStatus.DONE, slot=i)
        st = self._spec_stats
        st["proposed"] += k * len(active)
        st["accepted"] += accepted
        st["emitted"] += delivered
        st["launches"] += launches
        st["slot_launches"] += launches * len(active)
        st["rollbacks"] += rollbacks

    def _round_state(self) -> np.ndarray:
        """A round's [4, B] int32 host state for :meth:`_load_round`:
        each slot's next token, its position (inactive slots at the junk
        row ``max_len - 1``), its done flag (inactive slots done) and its
        request's seed."""
        active = np.array([r is not None for r in self._slot_req])
        return np.stack([self._next_tok,
                         np.where(active, self._pos, self.max_len - 1),
                         ~active, self._seed]).astype(np.int32)

    def _ngram_proposals(self, k: int) -> np.ndarray:
        """Host-side draft: for each active slot, the tokens that followed
        the most recent earlier occurrence of the sequence's trailing
        n-gram (padded by repeating the last token); zero launches."""
        out = np.zeros((self.max_batch, k), np.int32)
        for i, req in enumerate(self._slot_req):
            if req is not None:
                out[i] = self._ngram_one(req.prompt.tolist() + req.tokens, k)
        return out

    def _ngram_one(self, ctx: List[int], k: int) -> np.ndarray:
        n = max(1, int(self._spec.ngram))
        prop: List[int] = []
        for m in range(min(n, len(ctx) - 1), 0, -1):
            tail = ctx[-m:]
            for s in range(len(ctx) - m - 1, -1, -1):
                if ctx[s:s + m] == tail:
                    prop = list(ctx[s + m:s + m + k])
                    break
            if prop:
                break
        while len(prop) < k:
            prop.append(prop[-1] if prop else ctx[-1])
        return np.asarray(prop[:k], np.int32)

    def _note_stall(self):
        """Livelock guard: count consecutive zero-progress rounds while
        work exists; at the limit, fail the queue-head request (or else
        the first running one) with a capacity diagnostic instead of
        spinning in the evict -> re-admit cycle forever."""
        self._stall_rounds += 1
        self._stalls_total += 1
        if self._stall_rounds < self.max_stall_rounds:
            return
        self._stall_rounds = 0
        if self._queue:
            req = self._queue.popleft()
            self._retire(req, RequestStatus.FAILED,
                         self._stall_diagnostic(req))
            return
        for i, r in enumerate(self._slot_req):
            if r is not None:
                self._retire(r, RequestStatus.FAILED,
                             self._stall_diagnostic(r), slot=i)
                return

    def _decode_failure(self, e: Exception):
        """A decode or speculative round failed after its retries: the
        engine survives and the breaker judges the device.  The requests
        stay in their slots and the next step runs the round again: the
        failed call wrote only cache rows and outputs that the next run
        writes again from the same host state (the port writes its
        caches in place, so nothing is lost and nothing re-prefills, where
        JAX's donated caches are rebuilt).  When this failure opens the
        breaker, every request retires FAILED with its reason."""
        if self._breaker.record_failure(e):
            self._retire_all(RequestStatus.FAILED, self._breaker.reason)

    def _retire_all(self, status: str, reason: str):
        """The fail-fast path (open breaker, drain timeout): every queued,
        installing and running request retires with ``status`` at once."""
        while self._queue:
            self._retire(self._queue.popleft(), status, reason)
        for job in list(self._installing):
            req = job.plan.req
            if not req.terminal:
                self._abort_install(job)
                self._retire(req, status, reason)
        for i, r in enumerate(self._slot_req):
            if r is not None:
                self._retire(r, status, reason, slot=i)

    def _expire(self, t: float):
        """Retire running requests whose deadline has passed (queued ones
        expire at admission, :meth:`_next_admissible`).  Deadlines are
        checked at scheduler boundaries, so a request can overshoot by
        at most one device round."""
        for i, req in enumerate(self._slot_req):
            if req is not None and req.deadline is not None \
                    and t >= req.deadline:
                self._retire(
                    req, RequestStatus.TIMEOUT,
                    f"deadline expired mid-decode after "
                    f"{len(req.tokens)}/{req.max_new} tokens", slot=i)
        for job in list(self._installing):
            req = job.plan.req
            if not req.terminal and req.deadline is not None \
                    and t >= req.deadline:
                self._abort_install(job)
                self._retire(req, RequestStatus.TIMEOUT,
                             "deadline expired during the host-tier "
                             "reinstall")

    # -- the device-call funnel (retry + watchdog + fault-injection seam) ----
    def _device_invoke(self, kind: str, fn, *args, **kwargs):
        """Every device call lands here: the one override point that
        ``testing.faults.inject_engine_faults`` patches to make device
        calls fail or stall."""
        del kind
        return fn(*args, **kwargs)

    def _device_call(self, kind: str, fn, *args, **kwargs):
        """Run a device call of ``kind`` ("prefill", "decode", "verify",
        "draft", "prefix", "demote", "reinstall", "snapshot", "restore")
        under the retry policy, each attempt under a
        watchdog deadline of ``step_timeout`` seconds when it is set.
        Attempts beyond the first count into ``metrics()["retries"]``.

        A deadline measures host time, so it sees a device stall only
        in a call that waits for the device.  Every call starts with
        blocking host-to-device copies (the round's state, the ids and
        slots of a prefill), which wait for the work queued before it;
        the decode and verify calls also read their tokens back, so they
        wait for their own work.  The prefill, draft and prefix calls
        only queue their kernels: a stall inside them surfaces at the
        next call, whose copies wait for it (the next prefill of the
        round, or the round's decode or verify call)."""
        attempts = 0

        def attempt():
            nonlocal attempts
            attempts += 1
            if self.step_timeout is None:
                return self._device_invoke(kind, fn, *args, **kwargs)
            with watchdog.watch(f"serving:{kind}",
                                timeout=self.step_timeout):
                return self._device_invoke(kind, fn, *args, **kwargs)

        try:
            return self._retry.call(attempt)
        finally:
            if attempts > 1:
                self._retries[kind] = \
                    self._retries.get(kind, 0) + attempts - 1

    def _retire(self, req: Request, status: str,
                error: Optional[str] = None, slot: Optional[int] = None):
        """Move a request to a terminal status, free its slot and its
        cache resources, and stage it for the next step()'s report."""
        req.status = status
        req.error = error
        req.finished_at = _now()
        if status == RequestStatus.DONE:
            req.done = True
        if slot is not None:
            if status == RequestStatus.DONE and self._prefix is not None \
                    and req.tokens:
                # extend the trie with the EMITTED output before the
                # slot's resources go: rows [0, S-1) hold prompt and
                # emitted tokens only (a rejected speculative suffix
                # never reaches host state)
                self._prefix_extend(req, slot)
            self._slot_req[slot] = None
            self._release_slot(slot)
        self._retired[status] = self._retired.get(status, 0) + 1
        self._pending_report.append(req)


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a PAGED KV cache (the vLLM-style
    block-table design).

    The contiguous engine allocates max_batch x max_len rows up front,
    so device memory is pinned by the worst-case length.  Here the cache
    is a pool of ``num_blocks`` pages of ``block_size`` rows (default:
    half the contiguous allocation) shared by all slots; each slot holds
    a block table of page ids, claims pages as its sequence crosses page
    boundaries and returns them at retirement.  A slot whose next token
    has no page and no free page to claim is EVICTED: its pages go back
    to the pool and its request, with its sequence so far, to the queue
    front.  Decode runs ``gpt.decode_step_paged`` (the flash kernel
    reads the pool through the block table) and admission runs
    ``gpt.prefill_paged_batched`` into freshly claimed pages.

    Speculative rounds verify through ``gpt.verify_paged`` (the flash
    kernel reads the window's history off the pool); the pages behind a
    rejected suffix stay claimed as decode headroom until retirement.

    Prefix cache: spans are refcounted page ids (``PagePayload``).  A hit
    shares the cached pages FULLY inside the matched prefix straight
    through the slot's block table (refcount + 1, never written: the
    slot writes only past the shared boundary) and fills the suffix
    into private pages; a page's refcount counts its slot and every
    span that pins it, and it is free again at zero.

    Host tier: a demoted span's pages are gathered to host memory
    (``HostPagePayload``) and their pins released.  A host-tier hit
    claims fresh pool pages for the host pages, copies them in with one
    asynchronous copy a tensor and ONE in-place ``index_copy_`` into the
    pool, then promotes the span to a refcounted ``PagePayload`` of the
    fresh pages.  Handoff: spans export their leading run of whole pages
    in the canonical token layout and import as host pages."""

    def __init__(self, params, cfg, max_batch: int = 4,
                 max_len: int = 1024, eos_token_id: Optional[int] = None,
                 block_size: int = 64, num_blocks: Optional[int] = None,
                 **kw):
        self.block_size = int(block_size)
        if self.block_size < 1 or max_len % self.block_size:
            raise ValueError("max_len must be a multiple of block_size")
        self._max_blocks_per_slot = max_len // self.block_size
        # default pool: half the contiguous allocation — the paged
        # engine's whole point is that mixed lengths fit in less
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else max_batch * self._max_blocks_per_slot
                              // 2)
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got "
                             f"{self.num_blocks}")
        self._evictions = 0
        super().__init__(params, cfg, max_batch=max_batch,
                         max_len=max_len, eos_token_id=eos_token_id, **kw)

    def submit(self, prompt, max_new: int = 32, **kwargs) -> int:
        arr = np.asarray(prompt, np.int32).reshape(-1)
        # the base submit owns the empty/max_new/over-long errors; only
        # a valid request gets the worst-case page check
        if 1 <= arr.size <= self.max_len and max_new >= 1:
            longest = min(arr.size + max_new, self.max_len)
            worst = max(-(-self._bucket(longest) // self.block_size),
                        (longest - 1) // self.block_size + 1)
            if worst > self.num_blocks:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool "
                    f"only has {self.num_blocks}; raise num_blocks or "
                    "lower max_new")
        return super().submit(arr, max_new=max_new, **kwargs)

    # -- cache strategy ------------------------------------------------------
    def _init_cache(self):
        # pools [L, num_blocks, block_size, nH, hD] (+ int8 scales): the
        # contiguous cache layout with one "slot" per page
        self._cache = gpt.init_decode_cache(self.cfg, self.num_blocks,
                                            self.block_size, self.kv_dtype,
                                            device=self.device)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        # per-page refcount: 1 for the owning slot, +1 per prefix-cache
        # span pinning it; a page is free again at zero
        self._page_rc = np.zeros(self.num_blocks, np.int64)
        # the pool's bytes a page, scale planes included: the unit the
        # prefix cache's budget charges
        self._page_bytes = sum(c.numel() * c.element_size()
                               for c in self._cache.values()) \
            // self.num_blocks
        self._tables = np.full((self.max_batch, self._max_blocks_per_slot),
                               -1, np.int32)
        # the block tables the decode and verify programs read, refilled
        # from _tables before each round
        self._tables_dev = torch.full(self._tables.shape, -1,
                                      dtype=torch.int32, device=self.device)

    def _reset_cache(self):
        if self._prefix is not None:
            # cached page ids point into the old pool: drop them before
            # the pool and every refcount are rebuilt
            self._prefix.drop_device_entries()
        super()._reset_cache()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def metrics(self) -> Dict[str, Any]:
        m = super().metrics()
        m.update(num_blocks=self.num_blocks, block_size=self.block_size,
                 free_blocks=self.free_blocks, evictions=self._evictions)
        return m

    def _claim(self, n: int):
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._page_rc[pid] = 1
        return out

    def _unref_page(self, pid: int):
        self._page_rc[pid] -= 1
        if self._page_rc[pid] <= 0:
            self._page_rc[pid] = 0
            self._free.append(pid)

    def _unref_pages(self, pids):
        for pid in pids:
            self._unref_page(int(pid))

    def _release_slot(self, slot: int):
        self._unref_pages(b for b in self._tables[slot] if b >= 0)
        self._tables[slot] = -1

    # -- decode hooks --------------------------------------------------------
    def _decode_step_fn(self):
        cfg, ak = self.cfg, self.attn_kernel

        def step(p, c, extra, tok, pos):
            return gpt.decode_step_paged(p, c, extra, tok, pos, cfg,
                                         attn_kernel=ak)

        return step

    def _verify_step_fn(self):
        cfg, ak = self.cfg, self.attn_kernel

        def vstep(p, c, extra, toks, pos):
            return gpt.verify_paged(p, c, extra, toks, pos, cfg,
                                    attn_kernel=ak)

        return vstep

    def _decode_extra(self):
        return self._tables_dev

    def _load_round(self, state: np.ndarray):
        # the pages _scan_clamp claimed, evictions and shared prefix
        # pages all reach the programs through this copy
        super()._load_round(state)
        self._tables_dev.copy_(torch.from_numpy(self._tables))

    def _scan_clamp(self, active, max_tokens: int = 1) -> int:
        """Besides cache headroom, no slot may decode past its last
        ALLOCATED page.  Pages are claimed only as far as the next
        decode loop reaches (claiming a request's whole budget up front
        would bring back worst-case memory per request), and PARTIAL
        claims take whatever pages are free.  A slot left with zero
        backed headroom is EVICTED — pages released, sequence re-queued
        for a later prefill — never decoded into unbacked positions."""
        lim = self.max_len
        stalled = []
        for i in active:
            req = self._slot_req[i]
            remaining = min(req.max_new - len(req.tokens), max_tokens)
            want = min(int(self._pos[i]) + remaining, self.max_len - 1)
            self._ensure_pages(i, want)
            allocated = int((self._tables[i] >= 0).sum())
            headroom = min(
                allocated * self.block_size - 1 - int(self._pos[i]),
                self.max_len - 1 - int(self._pos[i]))
            if headroom < 1:
                stalled.append(i)
            else:
                lim = min(lim, headroom)
        if stalled:
            # re-admitted FIFO, in slot order
            self._requeue_front([self._evict(i) for i in stalled])
        if len(stalled) == len(active):
            return 0  # nobody can move; step() retries after re-admit
        return lim

    def _ensure_pages(self, slot: int, upto_pos: int) -> bool:
        """Claim pages toward backing positions [0, upto_pos] —
        PARTIAL: takes whatever the pool has."""
        need = upto_pos // self.block_size + 1
        have = int((self._tables[slot] >= 0).sum())
        if need <= have:
            return True
        got = self._claim(min(need - have, len(self._free)))
        if got:
            self._tables[slot, have:have + len(got)] = got
        return int((self._tables[slot] >= 0).sum()) >= need

    def _evict(self, slot: int) -> Request:
        """Preemption: release the slot's pages and return the request
        (sequence so far) for the caller to re-queue at the front."""
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._release_slot(slot)
        req.status = RequestStatus.QUEUED
        self._evictions += 1
        return req

    def _stall_diagnostic(self, req: Request) -> str:
        need = req.seq_so_far().size // self.block_size + 1
        return (f"request {req.rid} stalled in the evict/re-admit cycle "
                f"for {self.max_stall_rounds} rounds with zero tokens "
                f"produced: it needs {need} pages to advance but the "
                f"pool has {self.num_blocks} total ({self.free_blocks} "
                f"free) against {self.active_slots} running slots; "
                f"raise num_blocks or lower concurrency")

    # -- admission -----------------------------------------------------------
    def _reserve_slot(self, plan: _AdmitPlan) -> bool:
        """Claim the slot's pages before any device work: the pages the
        bucket's prefill writes, and at least one token of decode
        headroom (the first new write lands at pos S, page S // bs)
        — without it a sequence resumed exactly at a page boundary
        stalls at zero headroom and the evict/re-admit cycle
        livelocks.  A prefix hit puts its shared page ids in the table
        (refcount + 1) and claims private pages for the rest."""
        S = plan.seq.size
        need = max(-(-self._bucket(S) // self.block_size),
                   S // self.block_size + 1)
        install = plan.install if plan.hit else None
        if isinstance(install, dict):
            dev_list, host_list = install["device"], install["host"]
        elif install:
            dev_list, host_list = list(enumerate(install)), []
        else:
            dev_list, host_list = [], []
        # host pages need FRESH pool pages (their contents are copied
        # back); only the device pages are shared
        got = self._claim(max(need - len(dev_list), 0))
        if got is None:
            return False
        slot = plan.slot
        self._tables[slot] = -1
        for j, pid in dev_list:
            self._tables[slot, j] = pid
            self._page_rc[pid] += 1
        scatter: Dict[int, List] = {}
        gi = 0
        for j, payload, idx in host_list:
            pid = got[gi]
            gi += 1
            self._tables[slot, j] = pid
            ent = scatter.setdefault(id(payload), [payload, [], [], []])
            ent[1].append(idx)   # the page's index in the host tensors
            ent[2].append(pid)   # the fresh pool page
            ent[3].append(j)     # its global page number
        nshared = len(dev_list) + len(host_list)
        rest = got[gi:]
        self._tables[slot, nshared:nshared + len(rest)] = rest
        # the table holds everything: a device hit needs no install; the
        # host pages become the reinstall's copy jobs
        plan.install = list(scatter.values()) or None
        return True

    def _prefix_usable(self, length: int, spans, cap: int):
        """Only pages FULLY covered by the matched prefix are usable (the
        slot must never write into a shared page), so the usable prefix
        is the longest page-aligned run from position 0 over device pages
        (shared by id) and host pages (copied back); where both tiers
        hold a page, the device's wins.  Returns (P, the run's page ids)
        or, with host pages in the run, (P, {"device": [(j, pid)],
        "host": [(j, payload, index)]})."""
        if not spans:
            return 0, None
        dev: Dict[int, int] = {}
        host: Dict[int, Tuple[Any, int]] = {}
        for payload, m in spans:
            up = payload.usable_pages(m)
            if payload.tier == "host":
                for j, idx in up.items():
                    host[j] = (payload, idx)
            else:
                dev.update(up)
        run = 0
        while run in dev or run in host:
            run += 1
        shared_run = min(run * self.block_size, cap) // self.block_size
        if shared_run <= 0:
            return 0, None
        P = shared_run * self.block_size
        dev_list = [(j, dev[j]) for j in range(shared_run) if j in dev]
        host_list = [(j,) + host[j] for j in range(shared_run)
                     if j not in dev]
        if not host_list:
            return P, [pid for _, pid in dev_list]
        return P, {"device": dev_list, "host": host_list}

    def _install_host_info(self, plan: _AdmitPlan) -> Tuple[bool, int]:
        if isinstance(plan.install, dict):
            return True, len(plan.install["host"]) * self.block_size
        return False, 0

    def _suffix_fill(self, slot: int, tokens: np.ndarray, start: int):
        """The suffix as ONE windowed pass of the decode block over the
        slot's pages (``verify_paged`` without the head): ``start`` is
        page-aligned, so every row lands in a private page."""
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int32)
                                [None]).to(self.device)
        pos = torch.tensor([start], dtype=torch.int32, device=self.device)
        table = torch.from_numpy(self._tables[slot:slot + 1].copy()).to(
            self.device)
        gpt.verify_paged(self.params, self._cache, table, toks, pos,
                         self.cfg, attn_kernel=self.attn_kernel,
                         logits=False)

    def _insert_spans(self, key: np.ndarray, slot: int,
                      extend: bool = False):
        """Pin the slot's pages fully covered by ``key`` into the cache
        (no copy: the payload is page ids with a refcount, and a later
        hit installs them straight into another slot's table).  Only
        pages fully inside ``key`` are pinned, so a retirement's
        extension never pins a page holding rejected speculative rows
        (they sit past the emitted length)."""
        bs = self.block_size
        table = self._tables[slot]

        def make(a, b):
            pages: Dict[int, int] = {}
            for j in range(-(-a // bs), b // bs):
                pid = int(table[j])
                if pid < 0:
                    break
                pages[j] = pid
                self._page_rc[pid] += 1
            return PagePayload(a, b - a, pages, bs, self._page_bytes,
                               self._unref_pages,
                               gather_cb=self._gather_pages)

        self._prefix.insert(key, make, extend=extend)

    def _gather_pages(self, pids: List[int]):
        """The pool pages ``pids`` copied to host memory, [L, n,
        block_size, nH, hD] ((data, scale) pairs under int8): the read
        behind a demotion and a snapshot.  It returns once the copy has
        landed (``to_host``), so the caller may then release the
        pages."""
        sel = torch.tensor(pids, dtype=torch.long, device=self.device)
        c = self._cache

        def g(a):
            return to_host(byte_view(a).index_select(1, sel).view(a.dtype))

        k, v = g(c["k"]), g(c["v"])
        if "ks" in c:
            k, v = (k, g(c["ks"])), (v, g(c["vs"]))
        return k, v

    # -- handoff hooks on the paged layout -----------------------------------
    def _span_to_canonical(self, payload, a: int, b: int):
        """The span's leading run of whole pages in the canonical token
        layout (device pages gathered, host pages as they are); None when
        its leading pages were dropped by edge splits (capacity lost,
        never wrong K/V)."""
        pages = getattr(payload, "pages", None)
        if not pages:
            return None
        bs = self.block_size
        js = sorted(pages)
        run = [js[0]]
        for j in js[1:]:
            if j != run[-1] + 1:
                break
            run.append(j)
        a2, b2 = run[0] * bs, (run[-1] + 1) * bs
        if a2 < a or b2 > b:
            return None
        if payload.tier == "host":
            idx = [pages[j] for j in run]
            k = kv_map(lambda x: host_select(x, idx), payload.k)
            v = kv_map(lambda x: host_select(x, idx), payload.v)
        else:
            k, v = self._gather_pages([pages[j] for j in run])

        def flat(x):
            x = _canonical_array(x)
            return x.reshape((x.shape[0], len(run) * bs) + x.shape[3:])

        return kv_map(flat, k), kv_map(flat, v), a2, b2

    def _canonical_to_payload(self, k, v, a: int, b: int):
        """Canonical token rows repacked into whole host pages [L, n, bs,
        nH, hD]: only the pages fully inside [a, b) are kept (the
        straddled-page rule); a later hit copies them into fresh pool
        pages."""
        bs = self.block_size
        j = -(-a // bs)
        js: List[int] = []
        while (j + 1) * bs <= b:
            js.append(j)
            j += 1

        def repack(x):
            x = np.asarray(x)
            if not js:
                return np.zeros((x.shape[0], 0, bs) + x.shape[2:], x.dtype)
            return np.stack([x[:, jj * bs - a:jj * bs - a + bs]
                             for jj in js], axis=1)

        return HostPagePayload(a, b - a, {jj: i for i, jj in enumerate(js)},
                               bs, self._from_canonical(kv_map(repack, k)),
                               self._from_canonical(kv_map(repack, v)))

    # -- host-tier reinstall (copies into fresh pool pages) ------------------
    def _start_reinstall(self, plan: _AdmitPlan):
        """One asynchronous copy of each host tensor of every copy job's
        payload, whole ([L, n, bs, ...]: a few pages past the plan's
        travel too, where a host-side gather would cost a copy of the
        rest in host memory)."""
        xfer: Dict[int, Any] = {}
        tensors: List[torch.Tensor] = []
        events: List[Any] = []
        for payload, idxs, pids, js in plan.install:
            k = kv_map(lambda x: self._put(x, tensors, events), payload.k)
            v = kv_map(lambda x: self._put(x, tensors, events), payload.v)
            xfer[id(payload)] = (payload, k, v, pids, js, idxs)
        return xfer, tensors, events

    def _complete_reinstall(self, job: _InstallJob):
        """Copy each job's pages into its fresh pool pages with ONE
        in-place ``index_copy_`` a tensor (the plan's pages picked out of
        the copied payload on the device first when it used only some),
        then fill the suffix."""
        self._consume_copies(job)
        c = self._cache
        dev = self.device
        with torch.inference_mode():
            for payload, k, v, pids, _js, idxs in job.xfer.values():
                idx = torch.tensor(pids, dtype=torch.long, device=dev)
                sel = (None if idxs == list(range(len(payload.pages)))
                       else torch.tensor(idxs, dtype=torch.long, device=dev))
                for name, val in (("k", k), ("v", v)):
                    for plane, src in zip((name, name + "s"),
                                          kv_components(val)):
                        src = byte_view(src)
                        if sel is not None:
                            src = src.index_select(1, sel)
                        byte_view(c[plane]).index_copy_(1, idx, src)
            self._fill_reinstalled_suffix(job.plan)

    def _promote_installed(self, job: _InstallJob):
        """Pin the freshly written pages back into the trie: the host
        span becomes a refcounted device ``PagePayload`` again (+1 a page
        for the cache's co-ownership, as a prefill-time insert), so the
        next hit shares the page ids.  A span copied in part keeps its
        host copy."""
        for payload, _k, _v, pids, js, _idxs in job.xfer.values():
            if set(js) != set(payload.pages):
                continue
            for pid in pids:
                self._page_rc[pid] += 1
            newp = PagePayload(payload.start, payload.length,
                               dict(zip(js, pids)), self.block_size,
                               self._page_bytes, self._unref_pages,
                               gather_cb=self._gather_pages)
            if not self._prefix.promote(payload, newp):
                # a host eviction overtook the copy: nothing is shared
                newp.release()

    def _prefill_batch(self, slots: Sequence[int],
                       reqs: Sequence[Request]):
        """One prefill of a bucket's sequences straight into their
        (pre-reserved) pages; ids pad to whole pages."""
        seqs = [r.seq_so_far() for r in reqs]
        bucket = self._bucket(max(s.size for s in seqs))
        nblk = -(-bucket // self.block_size)
        ids = np.zeros((len(seqs), nblk * self.block_size), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :s.size] = s
        # only the prefill's pages; the rest of the claim is decode
        # headroom
        pages = self._tables[np.asarray(slots, np.intp)][:, :nblk]
        with torch.inference_mode():
            gpt.prefill_paged_batched(
                self.params, torch.from_numpy(ids).to(self.device),
                self.cfg, self._cache,
                torch.from_numpy(np.ascontiguousarray(pages)).to(
                    self.device), attn_kernel=self.attn_kernel)


class FusedB1Engine(ContinuousBatchingEngine):
    """``max_batch=1`` serving over the FUSED decode stack: every decode
    step is one ``gpt.decode_step_fused``, whose whole layer stack is
    ONE launch of the ``fused_decode`` kernel (the b1 latency path).
    Requires int8 params (``gpt.quantize_decode_params``); the cache
    lives in the kernel's flat ``[L, max_len, H]`` layout in the
    ``kv_dtype``'s storage, int8 adding float32 ``[L, max_len, nH]``
    scale planes.

    Admission prefills the prompt through the int8 per-op stack
    (``gpt.prefill_into_slots``; its attention through ``flash_decode``
    when ``attn_kernel="flash"``) into a ``[L, 1, max_len, nH, hD]``
    view of the zeroed flat cache: the bytes of JAX's fresh scratch
    cache, flattened, without a copy.  ``attn_kernel`` changes only the
    prefill; the fused kernel serves every decode step.

    Speculative rounds verify through ``gpt.verify_fused``: the window as
    k+1 fused decode steps, so the verify tokens are the fused decode's
    own, bit for bit.

    Prefix cache: spans are copies of the flat ``[L, span, H]`` rows; a
    hit zeroes the recycled cache whole (the fused prefill replaces
    rather than scatters), installs the prefix and feeds the suffix
    through the fused decode step a token, as the JAX engine's suffix
    program does, so the rows are the fused kernel's own.  A host-tier
    hit clears the previous occupant's rows the same way before the
    reinstalled prefix lands; handoff spans convert between the flat
    layout and the canonical ``[L, tokens, nH, hD]`` (scales ``[L,
    tokens, nH]`` and ``[..., nH, 1]``).

    Left out of this port: tensor-parallel replication."""

    _prefill_kind = "prefill_fused"

    def __init__(self, qparams, cfg, max_len: int = 1024,
                 eos_token_id: Optional[int] = None, **kw):
        if not isinstance(qparams["layers"]["qkv_w"], tuple):
            raise ValueError("FusedB1Engine needs int8 params "
                             "(gpt.quantize_decode_params)")
        if max_len <= 0 or max_len % 8 or (
                max_len > KV_CHUNK and max_len % KV_CHUNK):
            raise ValueError(
                f"FusedB1Engine max_len={max_len} must be a positive "
                "multiple of 8 (the fused kernel's cache-row group) and of "
                f"{KV_CHUNK} when above it (the KV streaming chunk)")
        super().__init__(qparams, cfg, max_batch=1, max_len=max_len,
                         eos_token_id=eos_token_id, **kw)

    def _init_cache(self):
        cfg = self.cfg
        L, H = cfg.num_layers, cfg.hidden_size
        dt = kv_storage_dtype(self.kv_dtype, cfg.dtype)
        self._cache = {"k": kv_zeros((L, self.max_len, H), dt, self.device),
                       "v": kv_zeros((L, self.max_len, H), dt, self.device)}
        if kv_has_scales(self.kv_dtype):
            for name in ("ks", "vs"):
                self._cache[name] = torch.zeros(
                    (L, self.max_len, cfg.num_heads), dtype=torch.float32,
                    device=self.device)

    def _decode_step_fn(self):
        cfg = self.cfg

        def step(p, c, extra, tok, pos):
            del extra
            return gpt.decode_step_fused(p, c, tok, pos, cfg)

        return step

    def _verify_step_fn(self):
        cfg = self.cfg

        def vstep(p, c, extra, toks, pos):
            del extra
            return gpt.verify_fused(p, c, toks, pos, cfg)

        return vstep

    # -- prefix-cache hooks on the flat [L, T, H] layout ---------------------
    def _read_span(self, slot: int, a: int, b: int) -> KVSpanPayload:
        del slot                                    # b1: one sequence
        c = self._cache
        k, v = c["k"][:, a:b], c["v"][:, a:b]
        if "ks" in c:
            k = (k, c["ks"][:, a:b])
            v = (v, c["vs"][:, a:b])
        return KVSpanPayload(_span_copy(k), _span_copy(v))

    @staticmethod
    def _write_span_update(cache, k, v, slot):
        del slot
        for name, comps in (("k", k), ("v", v)):
            P = comps[0].shape[1]
            byte_view(cache[name])[:, :P] = comps[0]
            if len(comps) > 1:
                cache[name + "s"][:, :P] = comps[1]

    def _admit_hit(self, plan: _AdmitPlan):
        # the recycled slot holds the previous occupant's cache whole:
        # zero it so stale rows past this prompt never alias real state
        for a in self._cache.values():
            byte_view(a).zero_()
        super()._admit_hit(plan)

    def _complete_reinstall(self, job: _InstallJob):
        # a hosted hit recycles the slot the same way: clear the previous
        # occupant's rows (in place) before the reinstalled prefix lands
        for a in self._cache.values():
            byte_view(a).zero_()
        super()._complete_reinstall(job)

    # -- handoff hooks on the flat [L, T, H] layout --------------------------
    def _span_to_canonical(self, payload, a: int, b: int):
        k, v, a2, b2 = super()._span_to_canonical(payload, a, b)
        nH, hD = self.cfg.num_heads, self.cfg.head_dim

        def conv(x):
            if isinstance(x, tuple):
                d, s = x
                return (d.reshape(d.shape[0], d.shape[1], nH, hD),
                        s.reshape(s.shape[0], s.shape[1], nH, 1))
            return x.reshape(x.shape[0], x.shape[1], nH, hD)

        return conv(k), conv(v), a2, b2

    def _canonical_to_payload(self, k, v, a: int, b: int):
        del a, b

        def conv(x):
            # canonical [L, t, nH, hD] (scales [L, t, nH, 1]) back to the
            # flat layout: the trailing head axes collapse
            return kv_map(lambda y: np.asarray(y).reshape(
                y.shape[0], y.shape[1], -1), x)

        return KVSpanPayload(self._from_canonical(conv(k)),
                             self._from_canonical(conv(v)), tier="host")

    def _suffix_fill(self, slot: int, tokens: np.ndarray, start: int):
        """One fused decode step a suffix token (no head), as the JAX
        engine's suffix program scans its decode step."""
        del slot
        dev = self.device
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int32)).to(
            dev)
        pos = torch.arange(start, start + tokens.size, dtype=torch.int32,
                           device=dev)
        for j in range(tokens.size):
            gpt.decode_step_fused(self.params, self._cache, toks[j:j + 1],
                                  pos[j:j + 1], self.cfg, logits=False)

    def _prefill_batch(self, slots: Sequence[int],
                       reqs: Sequence[Request]):
        (seq,) = [r.seq_so_far() for r in reqs]
        cfg = self.cfg
        L, T = cfg.num_layers, self.max_len
        ids = np.zeros((1, self._bucket(seq.size)), np.int32)
        ids[0, :seq.size] = seq
        view = {}
        for name, a in self._cache.items():
            byte_view(a).zero_()
            tail = cfg.head_dim if name in ("k", "v") else 1
            view[name] = a.view(L, 1, T, cfg.num_heads, tail)
        with torch.inference_mode():
            gpt.prefill_into_slots(
                self.params, torch.from_numpy(ids).to(self.device), cfg,
                view, torch.zeros(1, dtype=torch.long, device=self.device),
                attn_kernel=self.attn_kernel)
