"""Continuous-batching serving engines over the KV cache (port of
``paddle_tpu/inference/serving.py``: ``Request``, ``_derive_buckets``,
``SpeculativeConfig``, the scheduler core of
``ContinuousBatchingEngine``, ``PagedContinuousBatchingEngine`` and
``FusedB1Engine``, greedy speculative decoding on all three).

The host runs the scheduler — admission, retirement, slot assignment —
and the device runs two programs over one in-place KV cache:

* a batched admission prefill: every request admitted in a round whose
  sequence falls in the same length bucket is prefilled together, ids
  padded with 0 to the bucket, each sequence's K/V written straight
  into its slot (``gpt.prefill_into_slots``) or its pages
  (``gpt.prefill_paged_batched``);
* a K-step decode loop (the engine's decode step + greedy argmax per
  step) advancing every slot at its own position, with ONE host sync
  per K steps.

Priming follows the JAX engine: sequences pad to a bucket, so an
admitted slot starts at ``pos = S-1`` feeding its last real token; the
first decode step recomputes that row and its argmax is the next
token.  Inactive slots decode at ``max_len-1`` with ``done`` set: the
contiguous engine writes junk rows that no query attends, the paged
engine drops their writes (their block tables are all -1).  The
scheduler makes the same choices as the JAX one step for step, so
greedy streams match it.

The KV cache is stored as ``kv_dtype`` ("bf16" = the model dtype,
"int8" with per-row scales, "fp8"); every write quantizes on the way
in and the flash kernel dequantizes while it reads.

Speculative decoding (``speculative=``, greedy): a round proposes k
tokens a slot — k greedy steps of a small GPT or LLaMA draft over its
own contiguous cache, or the host n-gram proposer — then ONE verify
pass of the target over each slot's k+1-token window, and one host
sync reads the fed window and the target's tokens together.  The
accepted prefix plus the target's correction token are emitted; every
emitted token is the target's own, so the stream equals the
non-speculative one.  Rollback is host state: rows of a rejected suffix
are never attended and the next fed token overwrites its row (paged:
their pages stay claimed as headroom until retirement).

Left out (ROADMAP Queue 1): prefix cache and host tier, seeded and
sampled speculation, handoff and reinstall hooks, tensor-parallel mesh
(and the draft's replication over it), retries/breaker/deadlines/
cancel, observability, the ``PT_KV_DTYPE`` flag.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..incubate.nn.kernels.flash_decode import SUPPORTED_HEAD_DIMS
from ..incubate.nn.kernels.fused_decode import KV_CHUNK
from ..incubate.nn.kv_quant import (byte_view, kv_has_scales,
                                    kv_storage_dtype, kv_zeros,
                                    resolve_kv_dtype)
from ..models import decoding, gpt, llama
from .lifecycle import (AdmissionQueue, EngineClosedError, EngineState,
                        QueueFullError, RequestStatus, now as _now)

__all__ = ["ContinuousBatchingEngine", "PagedContinuousBatchingEngine",
           "FusedB1Engine", "Request", "RequestStatus", "EngineState",
           "QueueFullError", "EngineClosedError", "SpeculativeConfig"]


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
    """Draft-and-verify speculative decoding, greedy.

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
    error: Optional[str] = None
    submitted_at: float = 0.0
    # monotonic stamps; TTFT resolves at the host sync that returned the
    # first token, so a K-step decode loop stamps all K tokens at once
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    def seq_so_far(self) -> np.ndarray:
        """prompt + already-generated tokens — what a re-admission
        after a paged eviction must prefill."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])


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


class ContinuousBatchingEngine:
    """Greedy continuous-batching decoder for the GPT family.

    ``attn_kernel`` ("flash" default | "xla") — "flash" serves decode
    and prefill attention from the flash_decode kernel; "xla" runs the
    plain compositions.  ``kv_dtype`` ("bf16" default | "int8" |
    "fp8") — the KV cache's storage format; an explicit argument, since
    the JAX engine's ``PT_KV_DTYPE`` flag registry is not ported.
    ``device`` — CUDA unless ``"cpu"`` is passed; ``params`` must
    already lie there.  ``max_queue`` bounds the admission queue
    (``reject`` policy: submit raises :class:`QueueFullError`).
    ``max_stall_rounds`` — consecutive scheduler rounds without
    progress after which the stalled request retires FAILED with a
    capacity diagnostic (the livelock guard).  ``speculative`` — a
    :class:`SpeculativeConfig` (``True``: the n-gram proposer with
    k = 3) turns on draft-and-verify rounds; None or False, off."""

    # the metrics()["launches"] key of an admission prefill
    _prefill_kind = "prefill"

    def __init__(self, params, cfg, max_batch: int = 4,
                 max_len: int = 1024, eos_token_id: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 attn_kernel: str = "flash", kv_dtype: str = "bf16",
                 max_stall_rounds: int = 8, speculative: Any = None,
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
        self._stall_rounds = 0
        self._stalls_total = 0
        # admissions sent back to the queue front because their capacity
        # could not be reserved (paged: the pool was short of pages)
        self._deferred = 0
        self._buckets = _derive_buckets(max_len)
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)     # pos being fed
        self._next_tok = np.zeros(max_batch, np.int32)
        self._queue = AdmissionQueue(max_queue)
        self.state = EngineState.SERVING
        self._requests: Dict[int, Request] = {}
        self._pending_report: List[Request] = []
        self._next_rid = 0
        # device programs run, per kind ("prefill" / "decode")
        self._launch_counts: Dict[str, int] = {}
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
        if self.attn_kernel == "flash" and \
                dcfg.head_dim not in SUPPORTED_HEAD_DIMS:
            raise ValueError(
                f"draft head dim {dcfg.head_dim} is not one the flash_decode "
                f"kernel takes {SUPPORTED_HEAD_DIMS}; serve with "
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

    def _init_draft_cache(self):
        """The draft model's cache: contiguous ``[L, max_batch, max_len,
        ...]`` in the engine's ``kv_dtype`` whatever the target's layout
        (the draft is small), and for a LLaMA draft its rotary tables,
        built once."""
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
        """Per-round extra device argument of the decode step."""
        return None

    def _scan_clamp(self, active, max_tokens: int = 1) -> int:
        """Upper bound on the decode loop's length from cache headroom.
        Returns 0 when no active slot can advance (paged: after an
        eviction reshuffle)."""
        del max_tokens
        return min(self.max_len - 1 - int(self._pos[i]) for i in active)

    def _reserve_slot(self, slot: int, req: Request,
                      seq: np.ndarray) -> bool:
        """Claim per-slot capacity before any device work (paged:
        pages).  Returns False when the engine cannot host the request
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
    def submit(self, prompt, max_new: int = 32) -> int:
        """Enqueue a greedy generation request; returns its rid."""
        if self.state != EngineState.SERVING:
            raise EngineClosedError(
                f"engine is {self.state}; submissions are closed")
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
        # the rid is used up before the offer, so a rejected request
        # (QueueFullError) still takes one, as in the JAX engine
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new, submitted_at=_now())
        self._queue.offer(req)
        self._requests[req.rid] = req
        return req.rid

    def run(self, steps_per_sync: int = 16) -> Dict[int, List[int]]:
        """Serve until the queue and every slot are empty; returns
        {rid: generated tokens}.  Every request ends in a terminal
        status (DONE, or FAILED by the livelock guard)."""
        results: Dict[int, List[int]] = {}
        while self._has_work():
            for req in self.step(steps_per_sync):
                results[req.rid] = req.tokens
        return results

    def drain(self) -> Dict[int, List[int]]:
        """Stop admission, finish every queued and running request,
        and stop; later submits raise :class:`EngineClosedError`."""
        self.state = EngineState.DRAINING
        out = self.run()
        self.state = EngineState.STOPPED
        return out

    def step(self, max_tokens: int = 1) -> List[Request]:
        """Admit into free slots, advance every active slot up to
        ``max_tokens`` tokens, retire finished requests.  Returns the
        requests retired this iteration."""
        retired_before = len(self._pending_report)
        self._admit()
        self._decode_round(max_tokens, retired_before)
        out, self._pending_report = self._pending_report, []
        return out

    def status(self, rid: int) -> str:
        return self._requests[rid].status

    def request(self, rid: int) -> Request:
        return self._requests[rid]

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
        rounds, deferred admissions, KV storage format and cache bytes;
        with speculation, ``speculative``: the JAX engine's counters."""
        out = {
            "attn_kernel": self.attn_kernel,
            "kv_dtype": self.kv_dtype,
            "launches": dict(self._launch_counts),
            "decode_steps": self._decode_steps,
            "draft_steps": self._draft_steps,
            "decode_seconds": self._decode_seconds,
            "active_slots": self.active_slots,
            "queued": self.queued,
            "queue_high_water": self._queue.high_water,
            "stalls": self._stalls_total,
            "deferred_admissions": self._deferred,
            "cache_bytes": self.cache_bytes(),
        }
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
        return bool(self._queue) or self.active_slots > 0

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
        """Fill free slots in slot order from the queue head, reserve
        their capacity (whatever the pool cannot back yet goes back to
        the queue front, FIFO), then prefill every same-bucket group of
        this round in one program."""
        plans: List[Tuple[int, Request, np.ndarray]] = []
        for slot in range(self.max_batch):
            if self._slot_req[slot] is not None:
                continue
            if not self._queue:
                break
            req = self._queue.popleft()
            plans.append((slot, req, req.seq_so_far()))
        ready = []
        for idx, plan in enumerate(plans):
            if self._reserve_slot(*plan):
                ready.append(plan)
            else:
                self._requeue_front([p[1] for p in plans[idx:]])
                self._deferred += len(plans) - idx
                break
        while ready:
            b = self._bucket(ready[0][2].size)
            group = [p for p in ready if self._bucket(p[2].size) == b]
            ready = [p for p in ready if p not in group]
            self._prefill_batch([p[0] for p in group],
                                [p[2] for p in group])
            self._note_launch(self._prefill_kind)
            if self._draft_cache is not None:
                # the draft must cover the admitted sequences before it
                # can propose
                self._draft_prefill([p[0] for p in group],
                                    [p[2] for p in group])
                self._note_launch("draft_prefill")
            for slot, req, seq in group:
                self._finish_admit(slot, req, seq)

    def _prefill_batch(self, slots: Sequence[int],
                       seqs: Sequence[np.ndarray]):
        """One prefill of a bucket's sequences straight into their
        slots."""
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
                       seqs: Sequence[np.ndarray]):
        """Bring the draft cache up to date for (re-)admitted slots in ONE
        batched prefill of the full sequences so far, bucketed: the draft
        has no prefix cache, and this keeps its state at the target's
        slot positions."""
        spec = self._spec
        mod = _draft_family(spec.family)
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

    def _finish_admit(self, slot: int, req: Request, seq: np.ndarray):
        self._slot_req[slot] = req
        req.status = RequestStatus.RUNNING
        # prime: feed the last REAL token at pos len-1 — the next decode
        # step's argmax continues the sequence (for a fresh request that
        # is generated token #1; after an eviction the next unconsumed
        # token)
        self._pos[slot] = seq.size - 1
        self._next_tok[slot] = int(seq[-1])

    def _decode_many(self, K: int, tok, pos, done) -> np.ndarray:
        """K greedy decode steps on the device; one host sync at the
        end.  Done slots keep their position (their writes land on a
        row they own, or on a junk row) and feed the eos id.  Returns
        tokens [K, B]."""
        eos = -1 if self.eos is None else self.eos
        step_fn = self._decode_step_fn()
        extra = self._decode_extra()
        out = torch.empty((K, self.max_batch), dtype=torch.int32,
                          device=self.device)
        with torch.inference_mode():
            for s in range(K):
                logits, _ = step_fn(self.params, self._cache, extra, tok,
                                    pos)
                nxt = decoding.sample_token_pos(logits, None, pos, 0.0)
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
                pos = torch.where(done, pos, pos + 1)
                tok = nxt
                out[s] = nxt
        self._note_launch("decode")
        self._decode_steps += K
        return out.cpu().numpy()

    def _propose(self, k: int, tok, pos):
        """k greedy draft steps on the device, no host sync: drafts
        [B, k] int32.  Inactive slots ride along pinned at the junk row
        ``max_len - 1`` (JAX lets them run on and drops the writes past
        the cache; a torch index there raises); an active slot's k - 1
        steps stay below it (k < its headroom)."""
        spec = self._spec
        mod = _draft_family(spec.family)
        kw = {} if self._draft_rope is None else \
            {"rope_tables": self._draft_rope}
        last = self.max_len - 1
        out = torch.empty((self.max_batch, k), dtype=torch.int32,
                          device=self.device)
        for j in range(k):
            logits, _ = mod.decode_step_multi(
                spec.draft_params, self._draft_cache, tok, pos,
                spec.draft_cfg, attn_kernel=self.attn_kernel, **kw)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out[:, j] = tok
            pos = torch.clamp(pos + 1, max=last)
        self._note_launch("draft")
        self._draft_steps += k
        return out

    def _verify_many(self, tok, drafts, pos):
        """The verify program: ONE pass of the target over each slot's
        window [tok, drafts...] and the greedy target token at every
        position.  Returns the fed window and the target tokens, both
        [B, k + 1] on the device."""
        toks = torch.cat([tok[:, None], drafts], dim=1)
        logits, _ = self._verify_step_fn()(self.params, self._cache,
                                           self._decode_extra(), toks, pos)
        g = decoding.sample_window(logits, None, pos, 0.0)
        self._note_launch("verify")
        return toks, g

    def _decode_round(self, max_tokens: int, retired_before: int):
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
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
        active_mask = np.array([r is not None for r in self._slot_req])
        dev = self.device
        tok = torch.from_numpy(self._next_tok.copy()).to(dev)
        pos = torch.from_numpy(np.where(active_mask, self._pos,
                                        self.max_len - 1)
                               .astype(np.int32)).to(dev)
        done = torch.from_numpy(~active_mask).to(dev)
        t_scan = _now()
        toks = self._decode_many(K, tok, pos, done)
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
        active_mask = np.array([r is not None for r in self._slot_req])
        dev = self.device
        pos = torch.from_numpy(np.where(active_mask, self._pos,
                                        self.max_len - 1)
                               .astype(np.int32)).to(dev)
        tok = torch.from_numpy(self._next_tok.copy()).to(dev)
        launches = 1                                  # the verify
        t_scan = _now()
        with torch.inference_mode():
            if spec.has_model:
                drafts = self._propose(k, tok, pos)
                launches += 1
            else:
                drafts = torch.from_numpy(self._ngram_proposals(k)).to(dev)
            feed, g = self._verify_many(tok, drafts, pos)
            feed, g = torch.stack((feed, g)).cpu().numpy()
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
            self._slot_req[slot] = None
            self._release_slot(slot)
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

    Left out of this port: the prefix cache's shared pages (the per-page
    refcount is kept for it), the host tier, and handoff and reinstall
    hooks."""

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

    def submit(self, prompt, max_new: int = 32) -> int:
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
        return super().submit(arr, max_new=max_new)

    # -- cache strategy ------------------------------------------------------
    def _init_cache(self):
        # pools [L, num_blocks, block_size, nH, hD] (+ int8 scales): the
        # contiguous cache layout with one "slot" per page
        self._cache = gpt.init_decode_cache(self.cfg, self.num_blocks,
                                            self.block_size, self.kv_dtype,
                                            device=self.device)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        # per-page refcount: 1 for the owning slot (a prefix cache would
        # add one per span pinning it); a page is free again at zero
        self._page_rc = np.zeros(self.num_blocks, np.int64)
        self._tables = np.full((self.max_batch, self._max_blocks_per_slot),
                               -1, np.int32)

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
        # the block tables, copied to the device once per decode round
        return torch.tensor(self._tables, dtype=torch.int32,
                            device=self.device)

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
    def _reserve_slot(self, slot: int, req: Request,
                      seq: np.ndarray) -> bool:
        """Claim the slot's pages before any device work: the pages the
        bucket's prefill writes, and at least one token of decode
        headroom (the first new write lands at pos S, page S // bs)
        — without it a sequence resumed exactly at a page boundary
        stalls at zero headroom and the evict/re-admit cycle
        livelocks."""
        S = seq.size
        need = max(-(-self._bucket(S) // self.block_size),
                   S // self.block_size + 1)
        got = self._claim(need)
        if got is None:
            return False
        self._tables[slot] = -1
        self._tables[slot, :need] = got
        return True

    def _prefill_batch(self, slots: Sequence[int],
                       seqs: Sequence[np.ndarray]):
        """One prefill of a bucket's sequences straight into their
        (pre-reserved) pages; ids pad to whole pages."""
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

    Left out of this port: the prefix-cache and handoff hooks, and
    tensor-parallel replication."""

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

    def _prefill_batch(self, slots: Sequence[int],
                       seqs: Sequence[np.ndarray]):
        (seq,) = seqs
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
