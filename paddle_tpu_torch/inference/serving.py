"""Continuous-batching serving engine over the KV cache (port of
``paddle_tpu/inference/serving.py``: ``Request``, ``_derive_buckets``
and the scheduler core of ``ContinuousBatchingEngine``).

The host runs the scheduler — admission, retirement, slot assignment —
and the device runs two programs over one in-place KV cache:

* a batched admission prefill (``gpt.prefill_into_slots``): every
  request admitted in a round whose prompt falls in the same length
  bucket is prefilled together, ids padded with 0 to the bucket, each
  prompt's K/V written straight into its slot;
* a K-step decode loop (``gpt.decode_step_multi`` + greedy argmax per
  step) advancing every slot at its own position, with ONE host sync
  per K steps.

Priming follows the JAX engine: prompts pad to a bucket, so an
admitted slot starts at ``pos = S-1`` feeding its last real prompt
token; the first decode step recomputes that row and its argmax is
generated token #1.  Inactive slots decode at ``max_len-1`` with
``done`` set — junk rows that no query attends.  The scheduler makes
the same choices as the JAX one step for step, so greedy streams
match it.

Left out of this slice (ROADMAP Queue 1 items 7-9, 11-12): prefix
cache, speculative decoding, paged and fused engines, tensor-parallel
mesh, int8/fp8 KV cache, retries/breaker/deadlines, observability.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import decoding, gpt
from .lifecycle import (AdmissionQueue, EngineClosedError, EngineState,
                        QueueFullError, RequestStatus, now as _now)

__all__ = ["ContinuousBatchingEngine", "Request", "RequestStatus",
           "EngineState", "QueueFullError", "EngineClosedError"]


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = RequestStatus.QUEUED
    submitted_at: float = 0.0
    # monotonic stamps; TTFT resolves at the host sync that returned the
    # first token, so a K-step decode loop stamps all K tokens at once
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


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
    plain compositions.  ``device`` — CUDA unless ``"cpu"`` is passed;
    ``params`` must already lie there.  ``max_queue`` bounds the
    admission queue (``reject`` policy: submit raises
    :class:`QueueFullError`)."""

    def __init__(self, params, cfg, max_batch: int = 4,
                 max_len: int = 1024, eos_token_id: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 attn_kernel: str = "flash", device=None):
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"engine max_len={max_len} exceeds the model's "
                f"max_position_embeddings={cfg.max_position_embeddings}")
        if attn_kernel not in ("xla", "flash"):
            raise ValueError(
                f"attn_kernel must be 'xla' or 'flash', "
                f"got {attn_kernel!r}")
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['wte'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos = eos_token_id
        self.attn_kernel = attn_kernel
        self._cache = gpt.init_decode_cache(cfg, max_batch, max_len,
                                            device=self.device)
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
        req = Request(self._next_rid, prompt, max_new, submitted_at=_now())
        self._queue.offer(req)
        self._next_rid += 1
        self._requests[req.rid] = req
        return req.rid

    def run(self, steps_per_sync: int = 16) -> Dict[int, List[int]]:
        """Serve until the queue and every slot are empty; returns
        {rid: generated tokens}."""
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
        self._admit()
        self._decode_round(max_tokens)
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
        """Scheduler snapshot: device programs per kind (``launches``),
        decode steps run and their host-clock seconds, queue and slot
        gauges, cache bytes."""
        return {
            "attn_kernel": self.attn_kernel,
            "launches": dict(self._launch_counts),
            "decode_steps": self._decode_steps,
            "decode_seconds": self._decode_seconds,
            "active_slots": self.active_slots,
            "queued": self.queued,
            "queue_high_water": self._queue.high_water,
            "cache_bytes": sum(c.numel() * c.element_size()
                               for c in self._cache.values()),
        }

    # -- scheduler ---------------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self._queue) or self.active_slots > 0

    def _bucket(self, n: int) -> int:
        return _bucket(n, self._buckets)

    def _note_launch(self, kind: str):
        self._launch_counts[kind] = self._launch_counts.get(kind, 0) + 1

    def _admit(self):
        """Fill free slots in slot order from the queue head, then
        prefill every same-bucket group of this round in one program."""
        plans: List[Tuple[int, Request]] = []
        for slot in range(self.max_batch):
            if self._slot_req[slot] is not None:
                continue
            if not self._queue:
                break
            plans.append((slot, self._queue.popleft()))
        while plans:
            b = self._bucket(plans[0][1].prompt.size)
            group = [p for p in plans if self._bucket(p[1].prompt.size) == b]
            plans = [p for p in plans if p not in group]
            self._prefill_batch([s for s, _ in group],
                                [r for _, r in group], b)
            for slot, req in group:
                self._finish_admit(slot, req)

    def _prefill_batch(self, slots: Sequence[int],
                       reqs: Sequence[Request], bucket: int):
        ids = np.zeros((len(reqs), bucket), np.int32)
        for i, r in enumerate(reqs):
            ids[i, :r.prompt.size] = r.prompt
        with torch.inference_mode():
            gpt.prefill_into_slots(
                self.params, torch.from_numpy(ids).to(self.device),
                self.cfg, self._cache,
                torch.tensor(slots, dtype=torch.long, device=self.device),
                attn_kernel=self.attn_kernel)
        self._note_launch("prefill")

    def _finish_admit(self, slot: int, req: Request):
        self._slot_req[slot] = req
        req.status = RequestStatus.RUNNING
        # prime: feed the last REAL token at pos len-1 — the next decode
        # step's argmax is generated token #1
        self._pos[slot] = req.prompt.size - 1
        self._next_tok[slot] = int(req.prompt[-1])

    def _decode_many(self, K: int, tok, pos, done) -> np.ndarray:
        """K greedy decode steps on the device; one host sync at the
        end.  Done slots keep their position (their writes land on a
        junk row) and feed the eos id.  Returns tokens [K, B]."""
        eos = -1 if self.eos is None else self.eos
        out = torch.empty((K, self.max_batch), dtype=torch.int32,
                          device=self.device)
        with torch.inference_mode():
            for s in range(K):
                logits, _ = gpt.decode_step_multi(
                    self.params, self._cache, tok, pos, self.cfg,
                    attn_kernel=self.attn_kernel)
                nxt = decoding.sample_token_pos(logits, None, pos, 0.0)
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
                pos = torch.where(done, pos, pos + 1)
                tok = nxt
                out[s] = nxt
        self._note_launch("decode")
        self._decode_steps += K
        return out.cpu().numpy()

    def _decode_round(self, max_tokens: int):
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return
        # K bounded by cache headroom, rounded down to a power of two;
        # slots whose budget runs out mid-loop retire at the boundary
        # and the host drops their overshoot
        clamp = min(self.max_len - 1 - int(self._pos[i]) for i in active)
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
                self._retire(req, i)
            else:
                self._next_tok[i] = int(toks[-1, i])

    def _retire(self, req: Request, slot: int):
        req.status = RequestStatus.DONE
        req.finished_at = _now()
        self._slot_req[slot] = None
        self._pending_report.append(req)
