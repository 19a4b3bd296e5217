#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases; any failure is an uncaught exception and a non-zero exit:

1. setup — require CUDA, print the card's name and power limit
   (nvidia-smi), build every CUDA kernel of the serving and training
   paths from the sources in the checkout (one nvcc per source, all
   started together, beside them ``nvcc -Xptxas -v`` of
   flash_attention.cu) and print the build seconds, then each flash-
   attention instance's registers, spills, threads and shared memory.
2. kernels (serving) — hold ``flash_decode`` against its plain PyTorch
   version on the card at the serving path's shapes (float32 at atol
   1e-4; bf16 per element, see below); time the
   kernel, the plain version and ``F.scaled_dot_product_attention``
   with an explicit boolean mask (the yardstick, never called by the
   port), and compute each shape's bound from the bytes and operations
   its inputs need.  Then the paged layout and the int8/fp8 storage
   modes at the decode shape (B 8, T 1024, 16 heads of 128, q bf16,
   block size 64, a shuffled block table with -1 tail pages): paged
   decode in bf16, int8 and fp8, paged verify (W 4), contiguous decode
   in int8 and fp8, each held per element to its plain version and
   timed beside SDPA on the gathered, dequantized bf16 K/V (gather and
   dequantization untimed); and in each mode a paged call over an
   identity table must equal the contiguous kernel bit for bit.
3. kernels (training) — the flash-attention forward, dK/dV and dQ
   kernels against their plain versions at the training shape (B 8,
   S 1024, 16 heads of 128, bf16, causal, q/k/v strided slices of a
   packed qkv) and at float32, non-causal and ragged (S 1000, hD 64)
   cases; ``fused_ce_fwd`` at N 8192, V 50304, H 2048, bf16, with
   labels out of range.  float32 outputs are held at 1e-4 of the
   largest reference value, lse and z/picked at atol 1e-3.  Yardsticks:
   SDPA (``is_causal``) forward and its autograd backward;
   ``matmul_f32out`` + ``torch.logsumexp`` (two calls).  Each flash
   time has its achieved TFLOP/s and share of the bound beside it.
   The attention kernels (bf16 on the tensor cores, P and dS carried as
   two bf16 halves; float32 on the CUDA cores) and their plain versions
   both keep P and dS to float32 precision and round once, so each bf16
   element is held to |got - want| <= 2^-7 |want| + 1e-3: one rounding
   step of the reference value, plus room for float32 summation order
   near zero.  Then, reported and not asserted, why P is not rounded to
   bf16 once as in the TPU kernels: the backward with P and dS rounded
   once, computed in float32 and in float64 at the training shape, and
   the share of that per-element limit their difference takes.
4. reference — the serving engine on the card against the CPU engine
   (gpt_tiny f32, identical greedy streams); at kv_dtype bf16, int8 and
   fp8, the paged engine (block size 8, a pool of 18 pages, so
   admissions defer and a slot is evicted) and the contiguous engine on
   the card, with the flash kernels, against the CPU paged and
   contiguous engines: identical streams; then three train steps of
   gpt_tiny f32 on the card (flash kernels) against the CPU (plain
   versions) at (num_micro 1, remat False) and (2, True): losses at
   rel 1e-4.
5. serving — gpt3_1p3b at full width (24 layers, H 2048, 16 heads of
   128, V 50304, bf16, random weights from seed 0) behind
   ``ContinuousBatchingEngine(max_batch=8, max_len=1024,
   attn_kernel="flash")``: 12 requests with seeded prompt lengths
   32-700 and max_new 32, all DONE with 32 tokens; the kernel's launch
   count, reset just before, must equal 24 per decode step plus 24 per
   prefill program.  Then one ``decode_step_multi`` at that width,
   "flash" against "xla", logits finite and within atol 0.25, and a
   profile of where a decode step's time goes.  The same 12 requests
   then go through ``PagedContinuousBatchingEngine(block_size=64)``
   with its default pool of 64 pages at kv_dtype bf16, int8 and fp8,
   through the contiguous engine at int8 and fp8, and through the paged
   engine at bf16 with 26 pages (admissions defer, a slot is evicted).
   Counts reset before each run: 24 launches of the paged layout per
   decode step and 24 of the contiguous one per prefill program (the
   contiguous engine: 24 per decode step too), in the run's storage
   mode; every request DONE with 32 tokens, every page back in the
   pool; agreement with the contiguous bf16 streams is reported, not
   asserted (bf16 near-ties, other GEMM shapes).  Then one paged decode
   step per kv_dtype, flash against xla, within atol 0.25, profiled.
6. training — gpt3_1p3b bf16 at full width through
   ``hybrid.build_train_step(num_micro=1, remat=False)``, B 8, S 1024,
   float32 AdamW moments, one warm step then 4 steps under
   ``TrainLoop(max_inflight=2)`` on one seeded batch: every loss finite,
   step 5 below step 1, and 24 launches per step of each flash kernel
   (counts reset just before).  Step ms, tokens/s, peak memory and a
   one-step profile by kernel family.  Then the eval loss
   (``gpt.loss_fn`` under no_grad: exactly one ``fused_ce_fwd``
   launch) and one ``remat=True`` step (48 forward launches), both held
   to the differentiated no-remat loss at those params (atol 2e-3: the
   same bf16 hidden states, float32 logits, another summation order).
   Against the plain softmax composition (``use_flash=False``, which
   rounds P to bf16 and launches no flash kernel): its no-grad loss at
   those params and its loss at the
   seed-0 init (atol 2e-3), its gradients there (each leaf's
   ||g_flash - g_plain|| within 5e-2 of ||g_plain||), and its own
   5-step trajectory from that init (each loss within 1e-2 of the flash
   run's).
7. b1 int8 serving — the serving weights quantized by the port
   (``gpt.quantize_decode_params``).  ``fused_decode_layers`` against
   its plain version in four storage modes (an f32 cache at gpt_tiny
   width; bf16, int8 and fp8 at gpt3_1p3b) at positions 0, 7, 8, 255,
   256, 700 and 1023 of a seeded T 1024 cache: h_out row 0 within 2^-6
   of its largest value, the written rows within one step of their
   storage (bf16 step, int8 quantum, e4m3 step) plus 2^-16 of the row's
   largest value for the float32 sum order — layer 0 held to that, its
   int8 scales to 1e-5; layers >= 1 add 2^-7 of the row's largest value
   (the hidden state's own difference, carried through 24 layers, see
   ``_fused_errors``) and their scales 2^-7 — every other row bit for
   bit; the plain version on the card against the CPU at 24 layers (the
   witness of that carried difference); the kernel's time at positions
   64, 512 and 1023 beside the byte bound, the plain version's at 512.
   Then ``FusedB1Engine`` on the card against the CPU one (gpt_tiny f32,
   int8 weights, bf16/int8/fp8 caches: identical streams, one fused
   launch per decode step), and at full width: the serving workload's
   first 3 requests (601, 458, 373 tokens, max_new 32) through
   ``FusedB1Engine(max_len=1024)`` and the per-op int8
   ``ContinuousBatchingEngine(max_batch=1)`` at each kv_dtype, with
   exact launch counts (fused_decode once per decode step, flash_decode
   24 per prefill only), stream agreement reported; one step of each at
   pos 601 on a shared cache, profiled, and the per-op step timed (no
   single library call computes a layer stack: it stands in for one).
8. RMSNorm — the ``rms_norm`` kernel against ``rms_norm_plain`` in both
   rounding policies ("fused", the TPU kernel's; "llama", the LLaMA
   path's), float32 and bfloat16, at [8, 4096], [2048, 4096], [8, 128]
   and [7, 11008], and through a row stride: float32 per element within
   1e-6 |want| + 1e-7, bfloat16 equal or one step apart on at most 1e-3
   of the elements, rstd within 1e-6 relative; times beside
   ``F.rms_norm`` and the byte bound.  Then the LLaMA path's attention
   kernels at the shapes llama_7b gives them (32 heads of 128, bf16,
   unpacked q/k/v), per element at the limits of phase 2/3:
   ``flash_attention_fwd`` at generate's prefill (B 4, S 512, causal),
   ``flash_decode`` at the slot loop's decode step (B 8, T 1024, ragged)
   and at its longest ``prefill_into_slots`` (B 1, W = T = 600, pos 0).
9. LLaMA reference — llama_tiny (GQA 4/2) float32 at
   initializer_range 0.3: ``generate`` and the slot loop
   (``llama_slot_loop``, kv_dtype bf16 and int8) on the card's kernel
   route give the CPU plain route's greedy streams, launches exact.
10. LLaMA serving — llama_7b at full width (32 layers, H 4096, 32 heads
   of 128, FFN 11008, V 32000, bf16, seed 0) after the GPT trees are
   freed: ``generate`` of 4 x 512 tokens, 32 new, and the slot loop over
   8 prompts (32..700 tokens, max_len 1024, 32 new, "flash"), with exact
   launch counts (RMS "llama" 65 a forward pass, 64 a
   ``prefill_into_slots``; flash_attention_fwd 32 a generate prefill;
   flash_decode 32 a slot decode step or ``prefill_into_slots``); prefill
   ms, decode tok/s, one 8-slot step profiled, cache bytes, peak memory;
   the plain route on the same weights (streams reported), and both
   routes' first-step logits against the same steps in float32: the
   kernel route's largest error within 1.5 x the plain route's; beside
   it, negative controls (the kernel route with a fault injected around
   a wrapper: K/V heads rolled, attention zeroed, layer 0's first
   RMSNorm in the "fused" policy, flash_decode's newest row dropped)
   read against the same steps: each attention fault must break the
   bound (the RMS one, a rounding-level fault, is reported).
11. ring kernels — the ring variant of flash attention (a run-time q
   offset: key j visible to query i iff j <= i + offset) at one ring
   chunk of llama_7b (B 1, 1024 queries and keys, 32 heads of 128,
   causal), bfloat16 and float32, offsets -1024 (every row fully
   masked), -37, 0, 37, 1024 and 3072, and at the shape phase 15 gives
   it (llama_7b training, B 4, S 2048, bf16) at offsets 0, -37 and 37:
   forward, dK/dV and dQ (with an lse cotangent folded into delta) held
   per element to their plain versions at the limits of phase 3, lse at
   atol 1e-3, offset 0 bit for bit to the same kernels under
   ``flash_attention``'s entry; times beside the plain versions and
   SDPA with the offset's boolean mask (forward, autograd backward; at
   offsets >= 0 only; at the training shape and offset 0 also SDPA
   ``is_causal``, its flash backend), bounds from the visible pairs
   (bytes where none), achieved TFLOP/s and share of the bound.
12. ring replay — the 4 ranks of a 4-way ring over 4096 positions on one
   card through ``ring_attention_loop`` with a local hand-over, 16
   launches of each offset kernel: the outputs and dq/dk/dv of one
   backward against dense ``flash_attention`` over 4096 (float32 within
   1e-4 of the largest value; bfloat16, whose dK/dV sum across ranks in
   bf16 as in JAX, within 2^-6 in norm and 2^-4 of the largest value);
   both timed.
13. LLaMA training reference — llama_tiny (GQA 4/2) float32 through
   ``build_train_step(model=llama_stage_model(cfg, remat))``: three
   steps on the card (flash and RMS kernels) against the CPU (plain
   versions) at remat False and True, losses at rel 1e-4, launches
   exact.
14. LLaMA training — llama_7b's width (H 4096, 32 heads of 128, FFN
   11008, V 32000, untied head, bf16, seed-0 weights) with the depth
   cut to 8 layers (1.88 B parameters; float32 AdamW moments make
   ~22.6 GB of state): at the init, the kernel route's loss and
   gradients against the plain compositions' (``use_flash=False``) on
   one sequence (atol 2e-3; each leaf within 5e-2 in norm); then B 4,
   S 2048, one seeded batch, 1 warm + 4 steps through
   ``TrainLoop(max_inflight=2)`` (the loss must fall; launches exact:
   each flash kernel 8 a step, RMS "llama" 17), step ms, tokens/s, peak
   memory, a profile by family (flash fwd, flash bwd, GEMMs, RMS fwd,
   other) with the optimizer timed alone; one ``remat=True`` step; the
   RMS "llama" backward at [8192, 4096] bf16 against the same call on
   the CPU (dw one bf16 step per element; dx one step of the larger of
   the element and twice its first addend, see ``rms_backward_check``).
15. LLaMA sequence parallel — ``llama.loss_fn(sp_group=g)`` on a real
   one-rank NCCL group at that config (the ring at P = 1: the offset
   kernels, 8 launches each) against ``loss_fn`` without a group: loss
   within 1e-6 relative, each gradient leaf within 1e-3 in norm; a
   first call sets up the communicator, the second is counted and timed.
16. the seconds of each phase, the kernels line (flash_decode in each
   layout and storage mode that the serving runs launch, the training
   kernels, fused_decode in each storage mode, rms_norm in each policy,
   the ring variant's three kernels, ``flash_attention_with_lse_*``,
   with launches from phase 15 and times at its shape)
   and, last, the device line.

TF32 is off for every matmul (``allow_tf32 = False``), so float32
parity is not loosened by the card's TF32 mode.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,            # dense tensor-core bf16
            "float32": 67e12}              # CUDA-core float32
SERVE_TOL = 0.25                           # flash vs xla logits, bf16
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-3       # kernel vs plain, per element
F32_REL = 1e-4                             # training kernels, f32, of max
LOSS_TOL = 2e-3                            # eval / remat vs no-remat loss
PLAIN_GRAD_REL = 5e-2                      # flash vs plain composition,
PLAIN_TRAJ_TOL = 1e-2                      # per gradient leaf; 5 losses
HOST_LEAD_CYCLES = 2_000_000               # ~1 ms of device sleep


def _log(obj):
    print(json.dumps(obj), flush=True)


def _time_ms(fn, reps=20, flush=None):
    """Median of per-call CUDA-event times; ``flush`` (a large buffer)
    is rewritten before each call so the inputs start cold in L2.  A
    device-side sleep queued before the start event keeps the card busy
    while the host enqueues the call, so the time is the call's device
    time, not the host's dispatch latency (which otherwise lands inside
    the events whenever the card waits for the host)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _nvidia_smi(query):
    """First card's ``nvidia-smi --query-gpu=<query>`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _flash_ptxas_start(build):
    """Start ``nvcc -Xptxas -v`` on flash_attention.cu with the build's
    own flags, beside the build (its library is thrown away)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "flash_attention_ptxas.so"
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(build.CSRC_DIR / "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


# mangled names: the float32 kernels <float, hD>, the bf16 tensor-core
# kernels <hD, warps>
FLASH_KERNEL = re.compile(r"flash_attention_(fwd|bwd_dkv|bwd_dq)(_tc)?_kernel"
                          r"I(?:f)?Li(\d+)E(?:Li(\d+)E)?")


def flash_resources(proc, build):
    """Registers, spills and the launch's dynamic shared memory of each
    flash-attention kernel instance, from the ptxas report of
    :func:`_flash_ptxas_start` and the library's own
    ``pt_flash_attention_smem_bytes``."""
    log, _ = proc[0].communicate()
    if proc[0].returncode:
        raise RuntimeError(f"nvcc -Xptxas -v flash_attention.cu:\n{log}")
    proc[1].unlink(missing_ok=True)
    smem = build.load("flash_attention").pt_flash_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    rows, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = FLASH_KERNEL.search(line)
            cur = None
            if m:
                tc = bool(m.group(2))
                name = (f"flash_attention_{m.group(1)}"
                        f"{'_tc' if tc else ''} "
                        f"{'bfloat16' if tc else 'float32'} hD {m.group(3)}")
                cur = rows.setdefault(name, {
                    "threads": 32 * int(m.group(4)) if tc else 256,
                    "smem_bytes": smem(int(tc), int(m.group(3)), (
                        "fwd", "bwd_dkv", "bwd_dq").index(m.group(1)))})
        elif cur is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            cur["spill_store_bytes"], cur["spill_load_bytes"] = \
                int(st), int(ld)
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return rows


def _rates(times, bounds):
    """Achieved TFLOP/s and the share of the bound of each timed kernel
    (``<key>_ms`` in ``times``, its operations and bound in ``bounds``)."""
    return {"tflops": {k: b["ops"] / times[f"{k}_ms"] / 1e9
                       for k, b in bounds.items() if f"{k}_ms" in times},
            "bound_share": {k: b["bound_ms"] / times[f"{k}_ms"]
                            for k, b in bounds.items()
                            if f"{k}_ms" in times}}


def _work(B, W, T, nH, nKV, hD, pos, elem, kv_elem=None, scale_bytes=0,
          block_size=0):
    """Bytes and operations one call needs on these inputs: q read and
    out written once (``elem`` bytes a value), each visible K/V row read
    once per kv head (``kv_elem`` bytes a value, default ``elem``, plus
    ``scale_bytes`` of int8 scale), pos, and for the paged layout
    (``block_size`` > 0) the table entry of each visible page; 4*hD
    operations per visible (query, row) pair and head."""
    kv_elem = elem if kv_elem is None else kv_elem
    rows = [min(p + W - 1, T - 1) + 1 for p in pos]
    pairs = sum(min(p + j, T - 1) + 1 for p in pos for j in range(W))
    nbytes = 2 * B * W * nH * hD * elem \
        + 2 * sum(rows) * nKV * (hD * kv_elem + scale_bytes) + 4 * B
    if block_size:
        nbytes += 4 * sum(-(-r // block_size) for r in rows)
    return nbytes, 4 * hD * nH * pairs


def _limit_share(got, want, f32_tol, of_max=False):
    """The largest share of its limit that one element of got - want
    uses (the check passes at <= 1).  bfloat16: 2^-7 |want| + 1e-3 per
    element; float32: ``f32_tol``, times max(1, max |want|) when
    ``of_max``."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.bfloat16:
        return (diff / (BF16_RTOL * w.abs() + BF16_ATOL)).max().item()
    scale = max(1.0, w.abs().max().item()) if of_max else 1.0
    return diff.max().item() / (f32_tol * scale)


DECODE_CASES = [
    # name, B, W, T, nH, nKV, dtype, pos, packed (q/k/v sliced from qkv)
    ("decode", 8, 1, 1024, 16, 16, torch.bfloat16, "ragged", False),
    ("verify", 8, 4, 1024, 16, 16, torch.bfloat16, "ragged", False),
    ("prefill", 2, 512, 512, 16, 16, torch.bfloat16, "zero", True),
    ("prefill_1024", 2, 1024, 1024, 16, 16, torch.bfloat16, "zero", True),
    ("decode_gqa", 8, 1, 1024, 16, 4, torch.bfloat16, "ragged", False),
    ("decode_f32", 8, 1, 1024, 16, 16, torch.float32, "ragged", False),
]


def kernel_phase(fd, cases=DECODE_CASES, phase="kernel"):
    """``flash_decode`` against its plain version at each case's shapes
    (hD 128), timed beside its plain version, SDPA and the bound."""
    rng = np.random.default_rng(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    hD = 128
    results = []
    for name, B, W, T, nH, nKV, dt, pk, packed in cases:
        if pk == "zero":
            pos_l = [0] * B
        else:
            pos_l = [int(x) for x in rng.integers(0, T - W + 1, B)]
            pos_l[0], pos_l[-1] = 0, T - W
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")

        def rand(*shape):
            return torch.randn(shape, device="cuda").to(dt)

        if packed:
            qkv = rand(B, W, 3, nH * hD)
            q, k, v = (qkv[:, :, i].view(B, W, nH, hD) for i in range(3))
        else:
            q, k, v = rand(B, W, nH, hD), rand(B, T, nKV, hD), \
                rand(B, T, nKV, hD)
        got = fd.flash_decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        want = fd.flash_decode_attention_plain(q, k, v, pos)
        err = (got.float() - want.float()).abs().max().item()
        share = _limit_share(got, want, 1e-4)
        if not share <= 1:
            raise AssertionError(f"flash_decode {name}: max abs err {err}, "
                                 f"{share} of its limit")
        # the yardstick: one library call on the same inputs
        rep = nH // nKV
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(rep, 2).transpose(1, 2)
        vt = v.repeat_interleave(rep, 2).transpose(1, 2)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= pos[:, None, None] + torch.arange(W, device="cuda")
                [None, :, None])[:, None]
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max()
        nbytes, ops = _work(B, W, T, nH, nKV, hD, pos_l, q.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[str(dt).split(".")[-1]] * 1e3
        row = {
            "phase": phase, "name": name,
            "shape": f"B={B} W={W} T={T} nH={nH} nKV={nKV} hD={hD} "
                     f"{str(dt).split('.')[-1]}",
            "kernel_ms": _time_ms(
                lambda: fd.flash_decode_attention(q, k, v, pos),
                flush=flush),
            "plain_ms": _time_ms(
                lambda: fd.flash_decode_attention_plain(q, k, v, pos),
                reps=5, flush=flush),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask),
                flush=flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "max_abs_err": err, "limit_share": share,
            "library_max_abs_err": float(lib_err),
        }
        _log(row)
        results.append(row)
    return results


def _kv_store(kvq, x, mode):
    """``x`` (float32) stored in a K/V mode: "dense" (bf16), int8
    ``(data, scale)`` or bare fp8, quantized on the card."""
    if mode == "dense":
        return x.to(torch.bfloat16)
    data, scale = kvq.quantize_kv(x, mode)
    return data if scale is None else (data, scale)


def paged_kernel_phase(fd, kvq):
    """The paged layout and the int8/fp8 storage modes of flash_decode
    at the serving path's shapes, each held per element to its plain
    version; then, in each storage mode, a paged call over an identity
    table must equal the contiguous kernel bit for bit.  The yardstick
    is SDPA on a dense, gathered and dequantized bf16 K/V (the gather
    and dequantization not timed): no single library call reads a page
    table or an int8 cache."""
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    B, T, nH, nKV, hD, bs = 8, 1024, 16, 16, 128, 64
    mb = T // bs
    cases = [
        # name, W, paged, K/V storage mode
        ("paged_decode", 1, True, "dense"),
        ("paged_decode_int8", 1, True, "int8"),
        ("paged_decode_fp8", 1, True, "fp8"),
        ("paged_verify", 4, True, "dense"),
        ("decode_int8", 1, False, "int8"),
        ("decode_fp8", 1, False, "fp8"),
    ]
    results, positions = {}, {}
    for name, W, paged, mode in cases:
        if W not in positions:
            # one draw per window width, so the modes read the same rows
            positions[W] = [int(x) for x in rng.integers(0, T - W + 1, B)]
            positions[W][0], positions[W][-1] = 0, T - W
        pos_l = positions[W]
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        q = torch.randn((B, W, nH, hD), device="cuda").to(torch.bfloat16)
        rows = (B * mb, bs) if paged else (B, T)
        k, v = (_kv_store(kvq, torch.randn(rows + (nKV, hD), device="cuda"),
                          mode) for _ in range(2))
        if paged:
            # each slot's pages shuffled over the pool; -1 past the
            # pages its last query needs
            perm = torch.randperm(B * mb, generator=gen).view(B, mb)
            bt = torch.full((B, mb), -1, dtype=torch.int32)
            for b, p in enumerate(pos_l):
                used = (p + W - 1) // bs + 1
                bt[b, :used] = perm[b, :used]
            bt = bt.cuda()
            args = (q, k, v, bt, pos)
            call, plain = fd.flash_decode_paged, fd.flash_decode_paged_plain
            safe = bt.clamp_min(0).long()

            def dense(x):
                return kvq.dequantize_kv(x)[safe].reshape(
                    B, T, nKV, hD).to(torch.bfloat16)
        else:
            args = (q, k, v, pos)
            call = fd.flash_decode_attention
            plain = fd.flash_decode_attention_plain

            def dense(x):
                return kvq.dequantize_kv(x).to(torch.bfloat16)
        got = call(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        share = _limit_share(got, want, 1e-4)
        if not share <= 1:
            raise AssertionError(f"flash_decode {name}: max abs err {err}, "
                                 f"{share} of its limit")
        qt = q.transpose(1, 2)
        kt, vt = dense(k).transpose(1, 2), dense(v).transpose(1, 2)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= pos[:, None, None] + torch.arange(W, device="cuda")
                [None, :, None])[:, None]
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max()
        nbytes, ops = _work(B, W, T, nH, nKV, hD, pos_l, 2,
                            2 if mode == "dense" else 1,
                            4 if mode == "int8" else 0, bs if paged else 0)
        kv_name = "bfloat16" if mode == "dense" else mode
        row = {
            "phase": "kernel", "name": name,
            "shape": f"B={B} W={W} T={T} nH={nH} nKV={nKV} hD={hD} q "
                     f"bfloat16, K/V {kv_name}"
                     + (f", paged bs={bs}, shuffled table" if paged else ""),
            "kernel_ms": _time_ms(lambda: call(*args), flush=flush),
            "plain_ms": _time_ms(lambda: plain(*args), reps=5, flush=flush),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask),
                flush=flush),
            # operations at the bf16 rate of q
            **_bound(nbytes, ops, "bfloat16"),
            "max_abs_err": err, "limit_share": share,
            "library_max_abs_err": float(lib_err),
        }
        _log(row)
        results[name] = row
        del k, v, kt, vt, args
    # identity table: the paged kernel on the contiguous kernel's rows
    pos = torch.tensor(rng.integers(0, T, B), dtype=torch.int32,
                       device="cuda")
    q = torch.randn((B, 1, nH, hD), device="cuda").to(torch.bfloat16)
    ident = torch.arange(B * mb, dtype=torch.int32, device="cuda").view(B, mb)
    for mode in ("dense", "int8", "fp8"):
        k, v = (_kv_store(kvq, torch.randn((B, T, nKV, hD), device="cuda"),
                          mode) for _ in range(2))

        def pages(x):
            return kvq.kv_map(lambda a: a.reshape(
                (B * mb, bs) + tuple(a.shape[2:])), x)

        if not torch.equal(fd.flash_decode_paged(q, pages(k), pages(v),
                                                 ident, pos),
                           fd.flash_decode_attention(q, k, v, pos)):
            raise AssertionError(f"flash_decode {mode}: the paged call on "
                                 f"an identity table differs from the "
                                 f"contiguous kernel")
    _log({"phase": "kernel_identity_table", "shape": f"B={B} W=1 T={T} "
          f"nH={nH} hD={hD} bs={bs}", "modes": ["bfloat16", "int8", "fp8"],
          "bit_identical": True})
    del flush
    torch.cuda.empty_cache()
    return results


def reference_phase(gpt, Engine):
    """The card's flash engine against the CPU engine on gpt_tiny in
    float32: identical greedy streams."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu_params = gpt.init_params(cfg, seed=1, device="cpu")
    gpu_params = _to_device(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m)
            for n, m in ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))]
    streams = []
    for params, dev, ak in ((cpu_params, "cpu", "xla"),
                            (gpu_params, "cuda", "flash")):
        eng = Engine(params, cfg, max_batch=3, max_len=256,
                     attn_kernel=ak, device=dev)
        rids = [eng.submit(p, max_new=m) for p, m in reqs]
        out = eng.run(steps_per_sync=8)
        streams.append([out[r] for r in rids])
    if streams[0] != streams[1]:
        raise AssertionError(f"card stream {streams[1]} != CPU stream "
                             f"{streams[0]}")
    _log({"phase": "reference", "config": "gpt_tiny f32",
          "requests": len(reqs), "streams_identical": True})


def serving_phase(gpt, Engine, fd):
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    eng = Engine(params, cfg, max_batch=8, max_len=1024,
                 attn_kernel="flash", device="cuda")
    _log({"phase": "serving_setup", "params": gpt.param_count(params),
          "init_s": time.perf_counter() - t0,
          "cache_bytes": eng.metrics()["cache_bytes"]})
    # warm-up: cuBLAS handles and the kernel's first launch stay out of
    # the measured run
    eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)
    eng.run()
    L = cfg.num_layers
    base = eng.metrics()
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    fd.LAUNCHES = 0
    t0 = time.perf_counter()
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, (n,)), max_new=32)
            for n in lens]
    out = eng.run(steps_per_sync=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.LAUNCHES
    m = eng.metrics()
    steps = m["decode_steps"] - base["decode_steps"]
    prefills = m["launches"]["prefill"] - base["launches"]["prefill"]
    for rid in rids:
        req = eng.request(rid)
        if req.status != "DONE" or len(out[rid]) != 32:
            raise AssertionError(f"request {rid}: {req.status}, "
                                 f"{len(out.get(rid, []))} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out[rid]):
            raise AssertionError(f"request {rid}: token out of range")
    if launches != L * (steps + prefills) or steps < 1 or prefills < 1:
        raise AssertionError(
            f"flash_decode launches {launches} != {L} x ({steps} decode "
            f"steps + {prefills} prefill programs)")
    ttft = [eng.request(r).first_token_at - eng.request(r).submitted_at
            for r in rids]
    e2e = [eng.request(r).finished_at - eng.request(r).submitted_at
           for r in rids]
    dsec = m["decode_seconds"] - base["decode_seconds"]
    row = {"phase": "serving", "requests": len(rids),
           "prompt_lens": [int(n) for n in lens], "max_new": 32,
           "launches": launches, "decode_steps": steps,
           "prefill_programs": prefills,
           "decode_rounds": m["launches"]["decode"]
           - base["launches"]["decode"],
           "tokens": 32 * len(rids), "wall_s": wall,
           # the decode loops' host syncs also wait for the admission
           # prefills queued before them, so this rate includes them
           "decode_loop_s": dsec,
           "decode_loop_tok_s": 32 * len(rids) / dsec,
           "e2e_tok_s": 32 * len(rids) / wall,
           "ttft_mean_s": float(np.mean(ttft)),
           "ttft_max_s": float(np.max(ttft)),
           "e2e_latency_mean_s": float(np.mean(e2e))}
    _log(row)
    return cfg, params, row, launches, [out[r] for r in rids]


def compare_phase(gpt, cfg, params):
    """One decode step at full width, flash against xla, on a cache
    filled by the flash prefill; then where a decode step's time goes."""
    B, T = 8, 1024
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(32, 701, B)]
    cache = gpt.init_decode_cache(cfg, B, T, device="cuda")
    with torch.inference_mode():
        for i, n in enumerate(lens):
            ids = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device="cuda")
            gpt.prefill_into_slots(params, ids, cfg, cache,
                                   torch.tensor([i], device="cuda"),
                                   attn_kernel="flash")
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, B),
                           dtype=torch.int32, device="cuda")
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        c2 = {k: v.clone() for k, v in cache.items()}
        lf, _ = gpt.decode_step_multi(params, cache, tok, pos, cfg,
                                      attn_kernel="flash")
        lx, _ = gpt.decode_step_multi(params, c2, tok, pos, cfg,
                                      attn_kernel="xla")
        torch.cuda.synchronize()
        if not (torch.isfinite(lf).all() and torch.isfinite(lx).all()):
            raise AssertionError("non-finite logits")
        diff = (lf - lx).abs().max().item()
        agree = int((lf.argmax(-1) == lx.argmax(-1)).sum())
        if not diff <= SERVE_TOL:
            raise AssertionError(f"flash vs xla logits differ by {diff} "
                                 f"> {SERVE_TOL}")
        _log({"phase": "flash_vs_xla", "max_abs_logit_diff": diff,
              "atol": SERVE_TOL, "logit_std": lx.float().std().item(),
              "argmax_agree": f"{agree}/{B}"})
        for kernel in ("flash", "xla"):
            prof = _step_profile(
                lambda k=kernel: gpt.decode_step_multi(
                    params, cache, tok, pos, cfg, attn_kernel=k))
            _log(dict(phase="decode_step", attn_kernel=kernel, slots=B,
                      tok_s=B / prof["wall_ms"] * 1e3, **prof))


def _step_profile(step, families=(("flash_decode", ("flash_decode",)),)):
    """Wall time of one eager decode step ``step()`` (synchronised)
    against the device time the profiler sees in it, by kernel
    family."""
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    n = 10
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n * 1e3)
    wall_ms = statistics.median(windows)
    return dict(wall_ms=wall_ms, wall_ms_windows=windows,
                **_profile(step, n, wall_ms, list(families)))


def _profile(fn, n, wall_ms, families, top_n=8):
    """Device time of ``n`` calls of ``fn`` under torch.profiler, per
    call, by kernel family: each (family, name substrings) in order,
    then cuBLAS GEMMs (Hopper's are named nvjet_*), then the rest; the
    idle share is 1 - busy / ``wall_ms`` (an unprofiled call's wall
    time).  Host side: the operators' own CPU time per call (the rest
    of the wall time is Python and waiting), and the largest operators
    by that time."""
    clocks = _nvidia_smi("clocks.sm,power.draw")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    fam = {name: 0.0 for name, _ in families}
    fam.update(matmul=0.0, other=0.0)
    kernels, top, host = 0, [], []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if "CPU" in str(getattr(ev, "device_type", "")) \
                and ev.self_cpu_time_total:
            host.append((ev.self_cpu_time_total / n / 1e3, ev.count // n,
                         ev.key[:50]))
        if not us or "CUDA" not in str(getattr(ev, "device_type", "CUDA")):
            continue
        name = ev.key.lower()
        kernels += ev.count
        top.append((us / n / 1e3, ev.count // n, ev.key[:70]))
        hit = next((f for f, subs in families
                    if any(x in name for x in subs)), None)
        if hit is None and any(x in name for x in ("nvjet", "gemm",
                                                   "cutlass", "cublas",
                                                   "gemv")):
            hit = "matmul"
        fam[hit or "other"] += us
    dev_ms = {k: v / n / 1e3 for k, v in fam.items()}
    busy = sum(dev_ms.values())
    return {"sm_clock_power": clocks, "device_ms": dev_ms,
            "device_busy_ms": busy, "kernels_per_step": kernels / n,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "top_kernels_ms_count_name": sorted(top, reverse=True)[:top_n],
            "host_op_self_ms": sum(h[0] for h in host),
            "top_host_ops_ms_count_name": sorted(host, reverse=True)[:top_n]}


def _to_device(tree, dev):
    """A parameter tree (dicts, int8 (weight, scale) tuples) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, dev) for v in tree)
    return tree.to(dev)


def paged_reference_phase(gpt, Engine, PagedEngine):
    """gpt_tiny f32, at each kv_dtype: the paged engine on the card
    (flash kernels) gives exactly the greedy streams of the CPU paged
    engine ("xla") and of the CPU contiguous engine; so does the
    contiguous engine on the card.  The pool of 18 pages of 8 rows is
    small enough that admissions defer and a running slot is evicted."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu_params = gpt.init_params(cfg, seed=1, device="cpu")
    gpu_params = _to_device(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m)
            for n, m in ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))]
    paged_kw = {"block_size": 8, "num_blocks": 18}
    for kd in ("bf16", "int8", "fp8"):
        streams, pool = {}, {}
        for label, E, params, dev, ak in (
                ("cpu_contiguous_xla", Engine, cpu_params, "cpu", "xla"),
                ("cpu_paged_xla", PagedEngine, cpu_params, "cpu", "xla"),
                ("card_paged_flash", PagedEngine, gpu_params, "cuda",
                 "flash"),
                ("card_contiguous_flash", Engine, gpu_params, "cuda",
                 "flash")):
            paged = E is PagedEngine
            eng = E(params, cfg, max_batch=3, max_len=256, attn_kernel=ak,
                    kv_dtype=kd, device=dev, **(paged_kw if paged else {}))
            rids = [eng.submit(p, max_new=m) for p, m in reqs]
            out = eng.run(steps_per_sync=8)
            streams[label] = [out[r] for r in rids]
            if paged:
                m = eng.metrics()
                pool[label] = {k: m[k] for k in (
                    "evictions", "deferred_admissions", "free_blocks",
                    "num_blocks")}
                if m["free_blocks"] != m["num_blocks"]:
                    raise AssertionError(f"paged {label} {kd}: pages left "
                                         f"claimed: {pool[label]}")
        want = streams["cpu_contiguous_xla"]
        for label, got in streams.items():
            if got != want:
                raise AssertionError(f"{label} {kd}: stream {got} != CPU "
                                     f"contiguous stream {want}")
        card = pool["card_paged_flash"]
        if card["evictions"] < 1 or card["deferred_admissions"] < 1:
            raise AssertionError(f"the pool of 18 pages did not both defer "
                                 f"and evict: {card}")
        _log({"phase": "reference_paged", "config": "gpt_tiny f32",
              "kv_dtype": kd, "requests": len(reqs), **paged_kw,
              "engines": sorted(streams), "streams_identical": True,
              "pool": pool})


def paged_serving_phase(gpt, Engine, PagedEngine, fd, cfg, params,
                        contiguous_streams):
    """The serving phase's 12 requests at full width through the paged
    engine (block_size 64, the default pool of 64 pages) at kv_dtype
    bf16, int8 and fp8, through the contiguous engine at int8 and fp8,
    and through the paged engine at bf16 with a pool of 26 pages, where
    admissions defer and a slot is evicted.  Every launch count is set
    to 0 just before each run: the paged layout must serve every decode
    step (24 launches each) and the contiguous layout every admission
    prefill (24 each), in the run's storage mode; every request DONE
    with 32 tokens and, paged, every page back in the pool."""
    L = cfg.num_layers
    runs = [
        # label, engine, kv_dtype, extra engine arguments
        ("paged", PagedEngine, "bf16", {}),
        ("paged", PagedEngine, "int8", {}),
        ("paged", PagedEngine, "fp8", {}),
        ("contiguous", Engine, "int8", {}),
        ("contiguous", Engine, "fp8", {}),
        ("paged_tight", PagedEngine, "bf16", {"num_blocks": 26}),
    ]
    results, streams_of = {}, {}
    for label, E, kd, kw in runs:
        paged = E is PagedEngine
        if paged:
            kw = dict(block_size=64, **kw)
        eng = E(params, cfg, max_batch=8, max_len=1024, attn_kernel="flash",
                kv_dtype=kd, device="cuda", **kw)
        eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)   # warm-up
        eng.run()
        base = eng.metrics()
        rng = np.random.default_rng(0)
        lens = rng.integers(32, 701, 12)
        fd.reset_launches()
        t0 = time.perf_counter()
        rids = [eng.submit(rng.integers(0, cfg.vocab_size, (n,)),
                           max_new=32) for n in lens]
        out = eng.run(steps_per_sync=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"contiguous": fd.LAUNCHES, "paged": fd.PAGED_LAUNCHES,
                  **{f"mode_{k}": n for k, n in fd.MODE_LAUNCHES.items()}}
        m = eng.metrics()
        steps = m["decode_steps"] - base["decode_steps"]
        prefills = m["launches"]["prefill"] - base["launches"]["prefill"]
        for rid in rids:
            req = eng.request(rid)
            if req.status != "DONE" or len(out[rid]) != 32:
                raise AssertionError(f"{label} {kd} request {rid}: "
                                     f"{req.status}, "
                                     f"{len(out.get(rid, []))} tokens")
            if not all(0 <= t < cfg.vocab_size for t in out[rid]):
                raise AssertionError(f"{label} {kd} request {rid}: token "
                                     f"out of range")
        mode = "dense" if kd == "bf16" else kd
        want = {"contiguous": L * prefills + (0 if paged else L * steps),
                "paged": L * steps if paged else 0,
                "mode_dense": 0, "mode_int8": 0, "mode_fp8": 0}
        want["mode_dense"] += L * prefills
        want[f"mode_{mode}"] += L * steps
        if counts != want or steps < 1 or prefills < 1:
            raise AssertionError(f"{label} {kd}: flash_decode launches "
                                 f"{counts}, want {want} ({steps} decode "
                                 f"steps, {prefills} prefill programs)")
        if paged and m["free_blocks"] != m["num_blocks"]:
            raise AssertionError(f"{label} {kd}: {m['free_blocks']} of "
                                 f"{m['num_blocks']} pages free after the "
                                 f"drain")
        deferred = m["deferred_admissions"] - base["deferred_admissions"]
        evictions = m.get("evictions", 0) - base.get("evictions", 0)
        if label == "paged_tight" and not (deferred >= 1 and evictions >= 1):
            raise AssertionError(f"paged_tight: {deferred} deferred "
                                 f"admissions, {evictions} evictions")
        streams = [out[r] for r in rids]
        ttft = [eng.request(r).first_token_at - eng.request(r).submitted_at
                for r in rids]
        dsec = m["decode_seconds"] - base["decode_seconds"]
        same = sum(a == b for a, b in zip(streams, contiguous_streams))
        tokens_same = sum(x == y for a, b in zip(streams, contiguous_streams)
                          for x, y in zip(a, b))
        row = {"phase": "serving_kv", "engine": label, "kv_dtype": kd,
               **({"block_size": m["block_size"],
                   "num_blocks": m["num_blocks"]} if paged else {}),
               "cache_bytes": m["cache_bytes"], "launches": counts,
               "decode_steps": steps, "prefill_programs": prefills,
               "decode_rounds": m["launches"]["decode"]
               - base["launches"]["decode"],
               "stall_rounds": m["stalls"] - base["stalls"],
               "deferred_admissions": deferred, "evictions": evictions,
               "tokens": 32 * len(rids), "wall_s": wall,
               "decode_loop_s": dsec,
               "decode_loop_tok_s": 32 * len(rids) / dsec,
               "e2e_tok_s": 32 * len(rids) / wall,
               "ttft_mean_s": float(np.mean(ttft)),
               "ttft_max_s": float(np.max(ttft)),
               # reported, not asserted: bf16 near-ties, other GEMM shapes
               "streams_equal_to_contiguous_bf16": f"{same}/{len(rids)}",
               "tokens_equal_to_contiguous_bf16":
                   f"{tokens_same}/{32 * len(rids)}"}
        _log(row)
        results[(label, kd)] = row
        streams_of[(label, kd)] = streams
        del eng
        torch.cuda.empty_cache()

    def agree(a, b):
        return (f"{sum(x == y for x, y in zip(streams_of[a], streams_of[b]))}"
                f"/{len(streams_of[a])}")

    # reported, not asserted: the paged prefill pads to whole pages, so
    # cuBLAS sees other GEMM shapes and near-ties may break otherwise
    _log({"phase": "serving_kv_agreement",
          "paged_vs_contiguous": {kd: agree(("paged", kd),
                                            ("contiguous", kd))
                                  for kd in ("int8", "fp8")},
          "paged_26_pages_vs_paged_64_pages_bf16": agree(
              ("paged_tight", "bf16"), ("paged", "bf16"))})
    return results


def paged_compare_phase(gpt, cfg, params):
    """One paged decode step at full width per kv_dtype, flash against
    xla on the same pools (filled by the paged flash prefill): logits
    finite and within SERVE_TOL; then where a paged flash decode step's
    time goes."""
    B, bs = 8, 64
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(32, 701, B)]
    ids = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, B),
                       dtype=torch.int32, device="cuda")
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    # each slot's pages, shuffled over a pool that just holds them: the
    # prompt's pages and the page of the row this step writes
    need = [n // bs + 1 for n in lens]
    nb = sum(need)
    perm = rng.permutation(nb).astype(np.int32)
    table = np.full((B, 1024 // bs), -1, np.int32)
    for b, k in enumerate(need):
        table[b, :k] = perm[sum(need[:b]):sum(need[:b]) + k]
    bt = torch.from_numpy(table).cuda()
    for kd in ("bf16", "int8", "fp8"):
        pools = gpt.init_decode_cache(cfg, nb, bs, kd, device="cuda")
        with torch.inference_mode():
            for b, n in enumerate(lens):
                nblk = -(-n // bs)
                padded = np.zeros((1, nblk * bs), np.int64)
                padded[0, :n] = ids[b]
                gpt.prefill_paged_batched(
                    params, torch.from_numpy(padded).cuda(), cfg, pools,
                    bt[b:b + 1, :nblk], attn_kernel="flash")
            p2 = {k: v.clone() for k, v in pools.items()}
            lf, _ = gpt.decode_step_paged(params, pools, bt, tok, pos, cfg,
                                          attn_kernel="flash")
            lx, _ = gpt.decode_step_paged(params, p2, bt, tok, pos, cfg,
                                          attn_kernel="xla")
            torch.cuda.synchronize()
            if not (torch.isfinite(lf).all() and torch.isfinite(lx).all()):
                raise AssertionError(f"paged {kd}: non-finite logits")
            diff = (lf - lx).abs().max().item()
            agree = int((lf.argmax(-1) == lx.argmax(-1)).sum())
            if not diff <= SERVE_TOL:
                raise AssertionError(f"paged {kd}: flash vs xla logits "
                                     f"differ by {diff} > {SERVE_TOL}")
            prof = _step_profile(lambda: gpt.decode_step_paged(
                params, pools, bt, tok, pos, cfg, attn_kernel="flash"))
        _log(dict(phase="paged_decode_step", kv_dtype=kd, slots=B,
                  pool_pages=nb, block_size=bs, max_abs_logit_diff=diff,
                  atol=SERVE_TOL, argmax_agree=f"{agree}/{B}",
                  tok_s=B / prof["wall_ms"] * 1e3, **prof))
        del pools, p2
    torch.cuda.empty_cache()


def _err(got, want):
    """(max |got - want|, max |want|, the share of elements that differ,
    the share of its limit the worst element uses)."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(), want.float().abs().max().item(),
            (diff > 0).float().mean().item(),
            _limit_share(got, want, F32_REL, of_max=True))


def _bound(nbytes, ops, dt):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def train_kernel_phase(fa, fce, matmul_f32out):
    """The training kernels against their plain versions on the card,
    with times, bounds and the library yardsticks."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [
        # name, B, S, nH, hD, dtype, causal
        ("train", 8, 1024, 16, 128, torch.bfloat16, True),
        ("train_f32", 2, 1024, 16, 128, torch.float32, True),
        ("noncausal", 2, 1024, 16, 128, torch.bfloat16, False),
        ("ragged", 2, 1000, 16, 64, torch.bfloat16, True),
    ]
    results = {}
    for name, B, S, nH, hD, dt, causal in cases:
        dts = str(dt).split(".")[-1]
        qkv = torch.randn((B, S, 3, nH * hD), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (qkv[:, :, i].view(B, S, nH, hD) for i in range(3))
        dout = torch.randn((B, S, nH, hD), generator=gen,
                           device="cuda").to(dt)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                            causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
        torch.cuda.synchronize()
        w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0,
                                                         causal=causal)
        w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse,
                                                      delta, causal)
        w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                               causal)
        errs = {"out": _err(out, w_out), "dk": _err(dk, w_dk),
                "dv": _err(dv, w_dv), "dq": _err(dq, w_dq)}
        lse_err = (lse - w_lse).abs().max().item()
        _log({"phase": "kernel_training_check", "name": name,
              "limit_share": {k2: v2[3] for k2, v2 in errs.items()},
              "lse_max_abs_err": lse_err})
        for key, (err, _, _, share) in errs.items():
            if not share <= 1:
                raise AssertionError(f"flash_attention {name} {key}: max abs "
                                     f"err {err}, {share} of its limit")
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_attention {name} lse: {lse_err}")
        del w_out, w_lse, w_dk, w_dv, w_dq
        # the yardstick: SDPA forward and its autograd backward
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in leaves), is_causal=causal)
        lib_err = (lib_out.detach().transpose(1, 2).float()
                   - out.float()).abs().max().item()
        times = {
            "fwd_ms": _time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                              causal),
                               reps=10, flush=flush),
            "fwd_plain_ms": _time_ms(
                lambda: fa.flash_attention_with_lse_plain(
                    q, k, v, 0, causal=causal), reps=3, flush=flush),
            "fwd_library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in (q, k, v)),
                    is_causal=causal), reps=10, flush=flush),
            "dkv_ms": _time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, dout, lse, delta, causal), reps=10, flush=flush),
            "dkv_plain_ms": _time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
                q, k, v, dout, lse, delta, causal), reps=3, flush=flush),
            "dq_ms": _time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, dout, lse, delta, causal), reps=10, flush=flush),
            "dq_plain_ms": _time_ms(lambda: fa.flash_attention_bwd_dq_plain(
                q, k, v, dout, lse, delta, causal), reps=3, flush=flush),
            "bwd_library_ms": _time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, dout.transpose(1, 2), retain_graph=True),
                reps=10, flush=flush),
        }
        del lib_out, leaves
        # visible (query, key) pairs per (batch, head); elem bytes
        pairs = S * (S + 1) // 2 if causal else S * S
        n_el, e, stats = B * S * nH * hD, q.element_size(), B * nH * S * 4
        bounds = {
            "fwd": _bound(4 * n_el * e + stats, 4 * hD * pairs * B * nH, dts),
            "dkv": _bound(6 * n_el * e + 2 * stats, 8 * hD * pairs * B * nH,
                          dts),
            "dq": _bound(5 * n_el * e + 2 * stats, 6 * hD * pairs * B * nH,
                         dts),
            # the whole backward at FlashAttention-2's count (2.5x fwd)
            "bwd_pair": _bound(7 * n_el * e + 2 * stats,
                               10 * hD * pairs * B * nH, dts),
        }
        row = {"phase": "kernel_training", "name": name,
               "shape": f"B={B} S={S} nH={nH} hD={hD} {dts} "
                        f"causal={causal} packed qkv",
               **times, **_rates(times, bounds),
               "max_abs_err": {k2: v2[0] for k2, v2 in errs.items()},
               "max_ref": {k2: v2[1] for k2, v2 in errs.items()},
               "share_differing": {k2: v2[2] for k2, v2 in errs.items()},
               "limit_share": {k2: v2[3] for k2, v2 in errs.items()},
               "lse_max_abs_err": lse_err,
               "library_fwd_max_abs_err": lib_err,
               "bounds": bounds}
        _log(row)
        results[name] = row
        del qkv, q, k, v, dout, out, lse, delta, dk, dv, dq
    torch.cuda.empty_cache()

    # fused_ce_fwd at the eval shape
    N, V, H = 8192, 50304, 2048
    h = torch.randn((N, H), generator=gen, device="cuda").to(torch.bfloat16)
    W = (torch.randn((V, H), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    lbl = torch.randint(0, V, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lbl[:64:4], lbl[1:64:4], lbl[2:64:4] = -1, V, V + 100
    z, picked = fce.fused_ce_fwd(h, W, lbl)
    torch.cuda.synchronize()
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)
    errs = [(z - wz).abs().max().item(), (picked - wp).abs().max().item()]
    if not max(errs) <= 1e-3 or not bool((picked[:64:4] == 0).all()):
        raise AssertionError(f"fused_ce_fwd: z/picked errors {errs}")
    row = {"phase": "kernel_training", "name": "fused_ce",
           "shape": f"N={N} V={V} H={H} bfloat16, 48 labels out of range",
           "ms": _time_ms(lambda: fce.fused_ce_fwd(h, W, lbl), reps=3,
                          flush=flush),
           "plain_ms": _time_ms(lambda: fce.fused_ce_fwd_plain(h, W, lbl),
                                reps=3, flush=flush),
           # two calls: the float32-output product, then logsumexp
           "library_ms": _time_ms(lambda: torch.logsumexp(
               matmul_f32out(h, W.t()), -1), reps=3, flush=flush),
           "library_calls": "matmul_f32out (torch.mm out_dtype=float32) "
                            "+ torch.logsumexp",
           "max_abs_err": max(errs), "z_err": errs[0],
           "picked_err": errs[1], "atol": 1e-3,
           **_bound((N * H + V * H) * 2 + N * 12, 2 * N * V * H,
                    "bfloat16")}
    _log(row)
    results["fused_ce"] = row
    del h, W, lbl, z, picked, wz, wp, flush
    torch.cuda.empty_cache()
    return results


def _rounded_once_bwd(q, k, v, dout, lse, delta, dt):
    """(dk, dv, dq) of causal attention with P and dS rounded once to
    bf16 before their products, as the TPU kernels round them
    (``p.astype(do.dtype)``, ``ds.astype(q.dtype)``), every other step
    computed in ``dt``; results in bf16."""
    def bf(x):
        return x.to(torch.bfloat16).to(dt)
    S, scale = q.shape[1], q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    s = s.masked_fill(~_visible(S, S, 0, q.device), -1e30)
    p = torch.exp(s - lse.to(dt)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(dt), v.to(dt))
    ds = p * (dp - delta.to(dt)[..., None]) * scale
    return [t.to(torch.bfloat16) for t in (
        torch.einsum("bhqk,bqhd->bkhd", bf(ds), q.to(dt)),
        torch.einsum("bhqk,bqhd->bkhd", bf(p), dout.to(dt)),
        torch.einsum("bhqk,bkhd->bqhd", bf(ds), k.to(dt)))]


def rounding_witness_phase(fa):
    """Why the bf16 kernels keep P and dS to 16 bits (two bf16 halves)
    where the TPU kernels round them once: the backward with P and dS
    rounded once, computed twice, in float32 and in float64, at the GPT
    training shape (B 8, S 1024, 16 heads of 128, causal, the kernel's
    lse and delta).  Both are right; a score that lands near a bf16 tie
    rounds apart in the two, and the per-element limit of the kernel
    checks (one bf16 step + 1e-3) reads the difference.  Reported, not
    asserted: the share of that limit each gradient uses."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    B, S, nH, hD = 8, 1024, 16, 128
    q, k, v, dout = (torch.randn((B, S, nH, hD), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    f32 = _rounded_once_bwd(q, k, v, dout, lse, delta, torch.float32)
    f64 = _rounded_once_bwd(q, k, v, dout, lse, delta, torch.float64)
    row = {"phase": "rounding_witness",
           "shape": f"B={B} S={S} nH={nH} hD={hD} bfloat16 causal",
           "limit_share_f32_vs_f64": {
               n: _limit_share(a, b, F32_REL)
               for n, a, b in zip(("dk", "dv", "dq"), f32, f64)}}
    _log(row)
    del q, k, v, dout, out, lse, delta, f32, f64
    torch.cuda.empty_cache()
    return row


def train_reference_phase(gpt, hybrid):
    """gpt_tiny f32: three steps on the card (flash kernels) against the
    CPU (plain versions) on the same weights and batch; rel 1e-4."""
    cfg = gpt.gpt_tiny(dtype=torch.float32)
    params = gpt.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
    for num_micro, remat in ((1, False), (2, True)):
        losses = {}
        for dev in ("cpu", "cuda"):
            step, shard, init_opt = hybrid.build_train_step(
                cfg, num_micro=num_micro, remat=remat, device=dev)
            p = shard(params)
            o = init_opt(p)
            out = []
            for _ in range(3):
                loss, p, o = step(p, o, ids.to(dev), labels.to(dev))
                out.append(loss.item())
            losses[dev] = out
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        if not rel <= 1e-4:
            raise AssertionError(f"train reference {num_micro}/{remat}: "
                                 f"card {losses['cuda']} vs CPU "
                                 f"{losses['cpu']}")
        _log({"phase": "reference_training", "config": "gpt_tiny f32",
              "num_micro": num_micro, "remat": remat,
              "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
              "max_rel_diff": rel, "rtol": 1e-4})


def _train_batch(cfg, B=8, S=1024):
    """The training phases' one batch: seeded random ids and labels."""
    rng = np.random.default_rng(0)
    return tuple(torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda") for _ in range(2))


def training_phase(gpt, hybrid, TrainLoop, fa, fce):
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    B, S = 8, 1024
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, shard, init_opt = hybrid.build_train_step(
        cfg, num_micro=1, remat=False, device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    opt = init_opt(params)
    ids, labels = _train_batch(cfg, B, S)
    torch.cuda.synchronize()
    _log({"phase": "training_setup", "params": gpt.param_count(params),
          "init_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    first, params, opt = step(params, opt, ids, labels)     # warm
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    loop = TrainLoop(step, max_inflight=2)
    handles = []
    for _ in range(4):
        d, params, opt = loop.step(params, opt, ids, labels)
        handles.append(d)
    loop.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches()
    losses = [first.item()] + [float(d) for d in handles]
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    if launches != {name: 4 * L for name in launches}:
        raise AssertionError(f"flash_attention launches {launches} != "
                             f"{L} per step x 4 steps")
    step_ms = wall / 4 * 1e3
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(params, opt, ids, labels)

    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(one_step, 1, wall_ms, [
        ("flash_fwd", ("flash_attention_fwd",)),
        ("flash_bwd", ("flash_attention_bwd",))], top_n=24)
    row = {"phase": "training", "config": "gpt3_1p3b bf16", "B": B, "S": S,
           "num_micro": 1, "remat": False, "moments": "float32",
           "losses": losses, "launches_4_steps": launches,
           "step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3),
           "stall_s": loop.stall_seconds, "peak_memory_bytes": peak,
           "profiled_step_wall_ms": wall_ms, **prof}
    _log(row)

    # the differentiated (scan) loss at these params, no remat
    ref, grads = step.loss_and_grads(params, ids, labels)
    ref = ref.item()
    del grads
    fce.LAUNCHES = 0
    with torch.no_grad():
        ev = gpt.loss_fn(params, ids, labels, cfg).item()
    ce_launches = fce.LAUNCHES
    if ce_launches != 1 or not abs(ev - ref) <= LOSS_TOL:
        raise AssertionError(f"eval loss {ev} ({ce_launches} fused_ce "
                             f"launches) vs differentiated {ref}")
    # the same loss through the plain composition: no flash kernel
    with torch.no_grad():
        ev_plain = gpt.loss_fn(params, ids, labels, dataclasses.replace(
            cfg, use_flash=False)).item()
    _log({"phase": "eval_plain_attention", "differentiated_loss": ref,
          "plain_attention_loss": ev_plain, "atol": LOSS_TOL})
    if not abs(ev_plain - ref) <= LOSS_TOL:
        raise AssertionError(f"plain-attention loss {ev_plain} vs flash "
                             f"{ref}")
    step_r, _, _ = hybrid.build_train_step(cfg, num_micro=1, remat=True,
                                           device="cuda")
    fa.reset_launches()
    t0 = time.perf_counter()
    rl, params, opt = step_r(params, opt, ids, labels)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    rl = rl.item()
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}
    remat_launches = fa.launches()
    if remat_launches != want or not abs(rl - ref) <= LOSS_TOL:
        raise AssertionError(f"remat step: launches {remat_launches} (want "
                             f"{want}), loss {rl} vs {ref}")
    # the optimizer alone, on gradients at these params
    _, grads = step.loss_and_grads(params, ids, labels)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    hybrid.adamw_update(params, grads, opt, hybrid.AdamWConfig())
    b.record()
    torch.cuda.synchronize()
    del grads
    _log({"phase": "eval_and_remat", "differentiated_loss": ref,
          "eval_loss": ev, "fused_ce_launches": ce_launches,
          "remat_loss": rl, "remat_launches": remat_launches,
          "remat_step_ms": remat_ms, "atol": LOSS_TOL,
          "adamw_update_ms": a.elapsed_time(b),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return row, launches, ce_launches


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in _named_leaves(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def plain_training_phase(gpt, hybrid, fa, flash_losses):
    """The full-width training step against one through the plain
    softmax composition (``use_flash=False``), which launches no flash
    kernel: the gradients at the seed-0 init, then a 5-step trajectory
    from it on the training phase's batch, held to that phase's."""
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    ids, labels = _train_batch(cfg)
    step, shard, init_opt = hybrid.build_train_step(
        cfg, num_micro=1, remat=False, device="cuda")
    step_p, _, _ = hybrid.build_train_step(
        plain_cfg, num_micro=1, remat=False, device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    opt = init_opt(params)
    lf, gf = step.loss_and_grads(params, ids, labels)
    before = dict(fa.LAUNCHES)
    lp, gp = step_p.loss_and_grads(params, ids, labels)
    grad_rel = {}
    for (name, a), (_, b) in zip(_named_leaves(gf), _named_leaves(gp)):
        grad_rel[name] = ((a.float() - b.float()).norm()
                          / b.float().norm()).item()
    del gf, gp
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, params, opt = step_p(params, opt, ids, labels)
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    diffs = [abs(a - b) for a, b in zip(losses, flash_losses)]
    row = {"phase": "plain_attention_training",
           "config": "gpt3_1p3b bf16, use_flash=False", "B": 8, "S": 1024,
           "init_loss_flash": lf.item(), "init_loss_plain": lp.item(),
           "grad_rel_diff": grad_rel, "losses_plain": losses,
           "losses_flash": flash_losses, "loss_diffs": diffs,
           "flash_launches": launched,
           "synchronised_step_ms": times[1:],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "loss_atol": PLAIN_TRAJ_TOL, "grad_rel_tol": PLAIN_GRAD_REL}
    _log(row)
    if any(launched.values()):
        raise AssertionError(f"the plain path launched {launched}")
    if not abs(row["init_loss_flash"] - row["init_loss_plain"]) <= LOSS_TOL:
        raise AssertionError(f"init loss: flash {lf.item()} vs plain "
                             f"{lp.item()}")
    if not max(grad_rel.values()) <= PLAIN_GRAD_REL:
        raise AssertionError(f"gradients: flash vs plain {grad_rel}")
    if not max(diffs) <= PLAIN_TRAJ_TOL:
        raise AssertionError(f"trajectory: plain {losses} vs flash "
                             f"{flash_losses}")
    return row


FUSED_POS = (0, 7, 8, 255, 256, 700, 1023)   # of a T 1024 cache
FUSED_TIMED_POS = (64, 512, 1023)
FUSED_H_REL = 2 ** -6                        # h_out row 0, of its max
FUSED_SUM_ORDER = 2 ** -16     # of a written row's max: float32 sum order
FUSED_CARRIED = 2 ** -7        # of a written row's max, layers >= 1
FUSED_SCALE0_REL = 1e-5        # int8 scales of layer 0, relative
FUSED_WITNESS_POS = (0, 700)   # plain on the card against the CPU
FUSED_FAMILIES = (("fused_decode", ("fused_decode",)),
                  ("flash_decode", ("flash_decode",)))


def _fused_store(kvq, x, mode):
    """K/V x [2, L, T, nH, hD] float32 in the kernel's flat [L, T, H]
    layout and a storage mode ("f32"/"bf16": the model dtype, "int8"
    with [L, T, nH] scale planes, "fp8"): (ck, cv, scales or None)."""
    L, T, nH, hD = x.shape[1:]
    if mode == "int8":
        (ck, ks), (cv, vs) = (kvq.quantize_kv(x[i], "int8") for i in range(2))
        return (ck.reshape(L, T, nH * hD), cv.reshape(L, T, nH * hD),
                (ks.reshape(L, T, nH).contiguous(),
                 vs.reshape(L, T, nH).contiguous()))
    if mode == "fp8":
        ck, cv = (kvq.quantize_kv(x[i], "fp8")[0].reshape(L, T, nH * hD)
                  for i in range(2))
        return ck, cv, None
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    return (x[0].reshape(L, T, nH * hD).to(dt),
            x[1].reshape(L, T, nH * hD).to(dt), None)


def _fused_work(cfg, pos, kv_elem, scale_bytes, small_elem):
    """Bytes and operations of one fused step at ``pos``: every int8
    weight read once; the float32 per-channel scales, one per output
    column (qkv 3H, proj H, fc1 F, fc2 H: 5H + F a layer); the biases
    (qkv 3H, proj H, fc1 F, fc2 H) and LN parameters (4H) in the model
    dtype (9H + F a layer); the K/V history rows < pos read once (data
    and int8 scales), the two new rows written, h0 row 0 and pos read,
    h_out [8, H] written; 2 operations per weight and 4*hD per (row
    attended, head)."""
    L, H, F, nH = (cfg.num_layers, cfg.hidden_size, cfg.ffn_size,
                   cfg.num_heads)
    weights = L * (3 * H * H + H * H + 2 * H * F)
    row = H * kv_elem + nH * scale_bytes
    nbytes = (weights + L * (5 * H + F) * 4 + L * (9 * H + F) * small_elem
              + 2 * L * (pos + 1) * row + 4 * H + 4 + 32 * H)
    return nbytes, 2 * weights + 4 * H * L * (pos + 1)


def _fused_errors(kvq, got, want, before, pos, mode):
    """Kernel against plain at one position: h_out row 0 within
    FUSED_H_REL of its largest value, rows 1-7 zero; every row other
    than pos bit for bit; the written rows in storage units, each
    element within one step of its storage (bf16: 2^-7 |want|; fp8:
    2^-3 |want|; float32: none; int8: one quantum).  Layer 0 reads the
    same inputs in both versions: its rows add only FUSED_SUM_ORDER of
    the row's largest value (the float32 sums run in another order) and,
    for fp8, the subnormal step 2^-9; its int8 scales are held to
    FUSED_SCALE0_REL.  Layers >= 1 add FUSED_CARRIED of the row's
    largest value (int8 scales: FUSED_CARRIED relative): now and then a
    bf16 rounding point (LN output, q, p, GELU output) flips by one
    step, and the sharp softmax over the history carries such a step
    into the next layers — at 24 layers the hidden state differs by
    ~2e-3 of its largest value, as much as the plain version moves
    between the card and the CPU (``_plain_order_witness``).  Returns
    the shares of each limit used (all layers, and layer 0) and the
    errors."""
    h, w = got[0][0], want[0][0]
    err = (h - w).abs().max().item()
    out = {"h_max_abs_err": err, "h_max": w.abs().max().item()}
    out["h_share"] = err / (FUSED_H_REL * out["h_max"])
    if not (torch.isfinite(h).all() and out["h_share"] <= 1
            and not got[0][1:].any()):
        raise AssertionError(f"fused_decode {mode} pos {pos}: h_out {out}")
    keep = torch.ones(got[1].shape[1], dtype=torch.bool, device="cuda")
    keep[pos] = False
    shares = []
    for g, x, b in zip(got[1:], want[1:], before):
        if not torch.equal(kvq.byte_view(g)[:, keep],
                           kvq.byte_view(b)[:, keep]):
            raise AssertionError(f"fused_decode {mode} pos {pos}: a row "
                                 f"other than pos changed")
        gr, xr = g[:, pos].float(), x[:, pos].float()
        top = xr.abs().amax(1, keepdim=True)
        if g.dtype == torch.int8:
            lim = torch.ones_like(xr)
        elif g.dtype == torch.float32 and mode == "int8":   # scale planes
            lim = FUSED_CARRIED * xr.abs()
            lim[0] = FUSED_SCALE0_REL * xr[0].abs()
            out["scale_rel_layer0"] = max(
                out.get("scale_rel_layer0", 0.0),
                ((gr[0] - xr[0]).abs() / xr[0].abs()).max().item())
        else:
            step = {torch.bfloat16: 2 ** -7 * xr.abs(),
                    torch.float8_e4m3fn: 2 ** -3 * xr.abs(),
                    torch.float32: 0 * xr}[g.dtype]
            lim = step + FUSED_CARRIED * top
            lim[0] = step[0] + FUSED_SUM_ORDER * top[0] + (
                2 ** -9 if g.dtype == torch.float8_e4m3fn else 0.0)
        share = (gr - xr).abs() / lim
        shares.append((share.max().item(), share[0].max().item()))
    out["row_share"] = max(s for s, _ in shares)
    out["row_share_layer0"] = max(s for _, s in shares)
    if not out["row_share"] <= 1:
        raise AssertionError(f"fused_decode {mode} pos {pos}: written rows "
                             f"{shares} of their limits (all layers, "
                             f"layer 0)")
    return out


def _plain_order_witness(fdl, qlayers, h0, state, nH, eps, positions):
    """The plain version on the CPU against the plain version on the
    card, on the same inputs: only the order of the float32 sums differs
    (the CPU's GEMVs against cuBLAS), no kernel is involved.  How far
    h_out row 0 moves is how far a bf16 rounding flip, carried through
    the layers, moves it.  Returns {pos: max |diff| / max |h_out|}."""
    out = {}
    cpu_layers = _to_device(qlayers, "cpu")
    for pos in positions:
        rows = []
        for dev, layers in (("cuda", qlayers), ("cpu", cpu_layers)):
            ck, cv, *s = (t.to(dev, copy=True) for t in state)
            rows.append(fdl.fused_decode_layers_plain(
                h0.to(dev), layers, ck, cv, pos, nH, eps=eps,
                scales=tuple(s) or None)[0][0].cpu())
            del ck, cv, s
        out[str(pos)] = ((rows[0] - rows[1]).abs().max()
                         / rows[1].abs().max()).item()
    return out


def fused_kernel_phase(fdl, kvq, gpt, cfg, qparams):
    """fused_decode_layers against its plain version on the card in the
    four storage modes — an f32 cache at gpt_tiny width (seed-1 weights,
    quantized), bf16, int8 and fp8 at gpt3_1p3b (the serving weights,
    quantized) — at positions FUSED_POS of a T 1024 cache filled from a
    seed (``_fused_errors``); the plain version on the card against the
    CPU at FUSED_WITNESS_POS (bf16 cache); then the kernel's time at
    FUSED_TIMED_POS beside its bound, and the plain version's at 512.  No single library call computes a
    layer stack: the per-op int8 step's time stands in for it (the
    fused serving phase)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    tiny = gpt.gpt_tiny(dtype=torch.float32)
    tq = gpt.quantize_decode_params(gpt.init_params(tiny, seed=1,
                                                    device="cuda"), tiny)
    T = 1024
    results = {}
    for mode, c, qp in (("f32", tiny, tq), ("bf16", cfg, qparams),
                        ("int8", cfg, qparams), ("fp8", cfg, qparams)):
        L, H, nH = c.num_layers, c.hidden_size, c.num_heads
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        x = torch.randn((2, L, T, nH, H // nH), generator=gen, device="cuda")
        ck, cv, sc = _fused_store(kvq, x, mode)
        del x
        state = (ck, cv) + (sc or ())
        h0 = torch.zeros((8, H), device="cuda")
        h0[0] = torch.randn((H,), generator=gen, device="cuda")
        eps = c.layer_norm_epsilon

        def call(pos, fn=fdl.fused_decode_layers, tensors=state):
            ck, cv, *s = tensors
            return fn(h0, qp["layers"], ck, cv, pos, nH, eps=eps,
                      scales=tuple(s) or None)

        worst, h_rel = {}, {}
        for pos in FUSED_POS:
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            before = [t.clone() for t in state]
            got = call(p)
            torch.cuda.synchronize()
            want = call(p, fdl.fused_decode_layers_plain,
                        [t.clone() for t in before])
            errs = _fused_errors(kvq, got, want, before, pos, mode)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            h_rel[str(pos)] = errs["h_max_abs_err"] / errs["h_max"]
            for t, b in zip(state, before):      # the seeded cache again
                kvq.byte_view(t).copy_(kvq.byte_view(b))
            del before, got, want
        witness = {} if mode != "bf16" else {
            "plain_card_vs_cpu_h_rel": _plain_order_witness(
                fdl, qp["layers"], h0, state, nH, eps, FUSED_WITNESS_POS)}
        small_elem = qp["layers"]["ln1_g"].element_size()
        kv_elem = ck.element_size()
        timed = {}
        for pos in FUSED_TIMED_POS:
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            nbytes, ops = _fused_work(c, pos, kv_elem,
                                      4 if mode == "int8" else 0, small_elem)
            timed[str(pos)] = {"ms": _time_ms(lambda: call(p), flush=flush),
                               **_bound(nbytes, ops, "bfloat16")}
        p = torch.tensor([512], dtype=torch.int32, device="cuda")
        row = {"phase": "kernel_fused", "mode": mode,
               "shape": f"L={L} H={H} nH={nH} F={c.ffn_size} T={T} cache "
                        f"{mode}, params {str(c.dtype).split('.')[-1]}",
               "positions_checked": list(FUSED_POS), **worst,
               "max_abs_err": worst["h_max_abs_err"], "h_rel": h_rel,
               **witness, "timed": timed,
               "plain_ms_at_512": _time_ms(
                   lambda: call(p, fdl.fused_decode_layers_plain), reps=3,
                   flush=flush)}
        _log(row)
        results[mode] = row
        del state, ck, cv, sc
        torch.cuda.empty_cache()
    del flush, tq
    torch.cuda.empty_cache()
    return results


def fused_reference_phase(gpt, FusedEngine, fdl):
    """gpt_tiny f32 with int8 weights: FusedB1Engine on the card gives
    the CPU FusedB1Engine's greedy streams at kv_dtype bf16, int8 and
    fp8, with one fused launch per decode step (none on the CPU)."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu = gpt.quantize_decode_params(
        gpt.init_params(cfg, seed=1, device="cpu"), cfg)
    gpu = _to_device(cpu, "cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m)
            for n, m in ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))]
    for kd in ("bf16", "int8", "fp8"):
        streams, launched = [], []
        for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
            eng = FusedEngine(params, cfg, max_len=256, kv_dtype=kd,
                              device=dev)
            fdl.reset_launches()
            rids = [eng.submit(p, max_new=m) for p, m in reqs]
            out = eng.run(steps_per_sync=8)
            streams.append([out[r] for r in rids])
            launched.append((fdl.LAUNCHES, eng.metrics()["decode_steps"]))
        if streams[0] != streams[1]:
            raise AssertionError(f"fused {kd}: card stream {streams[1]} != "
                                 f"CPU stream {streams[0]}")
        if launched[0][0] != 0 or launched[1][0] != launched[1][1]:
            raise AssertionError(f"fused {kd}: launches (CPU, card) "
                                 f"{launched}")
        _log({"phase": "reference_fused", "config": "gpt_tiny f32, int8 "
              "weights", "kv_dtype": kd, "requests": len(reqs),
              "card_launches_decode_steps": launched[1],
              "streams_identical": True})


def fused_serving_phase(gpt, Engine, FusedEngine, fd, fdl, cfg, qparams):
    """gpt3_1p3b with int8 weights (the serving weights, quantized by
    the port) behind FusedB1Engine(max_len=1024) and the per-op int8
    ContinuousBatchingEngine(max_batch=1), at kv_dtype bf16, int8 and
    fp8, "flash" prefill: the serving workload's first 3 requests
    (prompt lengths 601, 458, 373), max_new 32, steps_per_sync 16.
    Counts reset just before each run: the fused engine launches
    fused_decode once per decode step and flash_decode only for its
    prefills (24 each, dense mode); the per-op engine never launches
    fused_decode.  Stream agreement between the two is reported, not
    asserted (random full-width weights give near-tied logits).  Then
    one step of each at the state after the first prompt, on one shared
    cache: logits compared, profiled, and the per-op step timed as the
    fused kernel's stand-in yardstick."""
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens][:3]
    runs, streams_of = {}, {}
    for kd in ("bf16", "int8", "fp8"):
        mode = "dense" if kd == "bf16" else kd
        for label in ("fused", "per_op"):
            fused = label == "fused"
            kw = dict(max_len=1024, kv_dtype=kd, attn_kernel="flash",
                      device="cuda")
            eng = (FusedEngine(qparams, cfg, **kw) if fused
                   else Engine(qparams, cfg, max_batch=1, **kw))
            eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)  # warm-up
            eng.run()
            base = eng.metrics()
            fd.reset_launches()
            fdl.reset_launches()
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new=32) for p in prompts]
            out = eng.run(steps_per_sync=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = eng.metrics()
            pk = "prefill_fused" if fused else "prefill"
            steps = m["decode_steps"] - base["decode_steps"]
            prefills = m["launches"][pk] - base["launches"][pk]
            counts = {"fused_decode": fdl.LAUNCHES,
                      **{f"fused_{k}": n for k, n in
                         fdl.MODE_LAUNCHES.items()},
                      "flash_decode": fd.LAUNCHES,
                      "flash_decode_paged": fd.PAGED_LAUNCHES,
                      **{f"flash_{k}": n for k, n in
                         fd.MODE_LAUNCHES.items()}}
            want = {k: 0 for k in counts}
            want["flash_decode"] = L * prefills
            want["flash_dense"] = L * prefills
            if fused:
                want["fused_decode"] = steps
                want[f"fused_{mode}"] = steps
            else:
                want["flash_decode"] += L * steps
                want[f"flash_{mode}"] += L * steps
            if counts != want or steps < 1 or prefills != len(prompts):
                raise AssertionError(f"{label} {kd}: launches {counts}, want "
                                     f"{want} ({steps} decode steps, "
                                     f"{prefills} prefills)")
            for rid in rids:
                req = eng.request(rid)
                if req.status != "DONE" or len(out[rid]) != 32 or not all(
                        0 <= t < cfg.vocab_size for t in out[rid]):
                    raise AssertionError(f"{label} {kd} request {rid}: "
                                         f"{req.status}, {out.get(rid)}")
            ttft = [eng.request(r).first_token_at
                    - eng.request(r).submitted_at for r in rids]
            dsec = m["decode_seconds"] - base["decode_seconds"]
            streams_of[(label, kd)] = [out[r] for r in rids]
            row = {"phase": "serving_b1", "engine": label, "kv_dtype": kd,
                   "prompt_lens": [int(n) for n in lens[:3]], "max_new": 32,
                   "cache_bytes": m["cache_bytes"], "launches": counts,
                   "decode_steps": steps, "prefills": prefills,
                   "tokens": 32 * len(rids), "wall_s": wall,
                   "decode_loop_s": dsec,
                   "decode_loop_tok_s": 32 * len(rids) / dsec,
                   "e2e_tok_s": 32 * len(rids) / wall,
                   "ttft_s": ttft, "ttft_mean_s": float(np.mean(ttft))}
            _log(row)
            runs[(label, kd)] = row
            del eng
            torch.cuda.empty_cache()
        a, b = streams_of[("fused", kd)], streams_of[("per_op", kd)]
        _log({"phase": "serving_b1_agreement", "kv_dtype": kd,
              "streams_equal": f"{sum(x == y for x, y in zip(a, b))}/3",
              "tokens_equal": f"{sum(p == q for x, y in zip(a, b) for p, q in zip(x, y))}/96"})

    # one step of each engine's decode at the state after prompt 0
    n0 = int(lens[0])
    ids = torch.tensor(prompts[0], device="cuda")[None]
    tok = torch.tensor(prompts[1][:1], dtype=torch.int32, device="cuda")
    pos = torch.tensor([n0], dtype=torch.int32, device="cuda")
    steps = {}
    for kd in ("bf16", "int8", "fp8"):
        cache = gpt.init_decode_cache(cfg, 1, 1024, kd, device="cuda")
        with torch.inference_mode():
            gpt.prefill_into_slots(qparams, ids, cfg, cache,
                                   torch.zeros(1, dtype=torch.long,
                                               device="cuda"),
                                   attn_kernel="flash")
            flat = gpt.flatten_decode_cache(cache, cfg)   # the same storage

            def fused_step():
                return gpt.decode_step_fused(qparams, flat, tok, pos, cfg)

            def per_op_step():
                return gpt.decode_step_multi(qparams, cache, tok, pos, cfg,
                                             attn_kernel="flash")

            lf, lp = fused_step()[0], per_op_step()[0]
            torch.cuda.synchronize()
            if not (torch.isfinite(lf).all() and torch.isfinite(lp).all()):
                raise AssertionError(f"b1 step {kd}: non-finite logits")
            row = {"phase": "b1_step", "kv_dtype": kd, "pos": n0,
                   "fused_vs_per_op_max_abs_logit_diff":
                       (lf - lp).abs().max().item(),
                   "logit_std": lp.std().item(),
                   "argmax_equal": bool(lf.argmax() == lp.argmax()),
                   "per_op_int8_step_ms": _time_ms(per_op_step, reps=10)}
            for label, fn in (("fused", fused_step), ("per_op", per_op_step)):
                prof = _step_profile(fn, FUSED_FAMILIES)
                row[label] = dict(tok_s=1e3 / prof["wall_ms"], **prof)
        _log(row)
        steps[kd] = row
        del cache, flat
        torch.cuda.empty_cache()
    return runs, steps


RMS_CASES = ((8, 4096), (2048, 4096), (8, 128), (7, 11008))
RMS_F32_REL, RMS_F32_ABS = 1e-6, 1e-7   # float32 out, per element
RMS_BF16_STEP_SHARE = 1e-3   # bf16: elements one step apart, at most
RMS_RSTD_REL = 1e-6          # "fused" rstd, relative
LLAMA_ROUTE_FACTOR = 1.5     # first-step logits vs float32, of plain's
# negative controls the route bound must fail (the RMS-policy control is
# a rounding-level fault, below bf16 noise: reported only)
LLAMA_MUST_FAIL = ("kv_heads_rolled", "attention_zeroed",
                   "newest_row_dropped")
LLAMA_FAMILIES = (("rms_norm", ("rms_norm",)),
                  ("flash_decode", ("flash_decode",)))


def _bf16_step(t):
    """The bfloat16 step (unit in the last place) at each |t| (float32;
    the smallest normal's step below it)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _bf16_steps(got, want):
    """Per element, how many bfloat16 steps apart got and want are (the
    distance of their bit patterns on the ordered line of values)."""
    def ordered(t):
        b = t.view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    return (ordered(got) - ordered(want)).abs()


def _rms_errors(got, want, rstd=None, want_rstd=None):
    """The RMS kernel against its plain version, per element: float32
    within RMS_F32_REL |want| + RMS_F32_ABS; bfloat16 equal, or one step
    apart on at most RMS_BF16_STEP_SHARE of the elements (the float32
    sum runs in another order, so rstd may cross a rounding boundary);
    "fused" rstd within RMS_RSTD_REL.  Raises past a limit; returns
    (max |got - want|, share of elements that differ)."""
    diff = (got.float() - want.float()).abs()
    err, share = diff.max().item(), (diff > 0).float().mean().item()
    if got.dtype == torch.bfloat16:
        steps = _bf16_steps(got, want)
        ok = steps.max().item() <= 1 and share <= RMS_BF16_STEP_SHARE
    else:
        ok = bool((diff <= RMS_F32_REL * want.float().abs()
                   + RMS_F32_ABS).all())
    if rstd is not None:
        rel = ((rstd - want_rstd).abs() / want_rstd).max().item()
        ok = ok and rel <= RMS_RSTD_REL
    if not ok:
        raise AssertionError(f"rms_norm {got.dtype} {tuple(got.shape)}: max "
                             f"abs err {err}, {share} of elements differ")
    return err, share


def rms_kernel_phase(fnr):
    """The RMS kernel against its plain version on the card, both
    policies, float32 and bfloat16, at the LLaMA path's rows (8 decode
    rows and 4 x 512 prefill rows of llama_7b, 8 rows of llama_tiny) and
    an odd case (7 rows of 11008); times of the kernel, the plain
    version and ``F.rms_norm`` (the one PyTorch call computing the same
    function, never called by the port), and the byte bound.  One more
    call reads x through a row stride (every other row)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    eps = 1e-6
    results = {}
    for N, H in RMS_CASES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((N, H), generator=gen, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn((H,), generator=gen,
                                       device="cuda")).to(dt)
            for policy in fnr.POLICIES:
                got, rstd = fnr.rms_norm(x, w, eps, policy)
                torch.cuda.synchronize()
                want, want_rstd = fnr.rms_norm_plain(x, w, eps, policy)
                err, share = _rms_errors(got, want, rstd, want_rstd)
                lib = F.rms_norm(x, (H,), w, eps)
                e = x.element_size()
                nbytes = 2 * N * H * e + H * e + (4 * N if rstd is not None
                                                  else 0)
                row = {"phase": "kernel_rms", "policy": policy,
                       "shape": f"N={N} H={H} {str(dt).split('.')[-1]}",
                       "ms": _time_ms(lambda: fnr.rms_norm(x, w, eps, policy),
                                      flush=flush),
                       "plain_ms": _time_ms(
                           lambda: fnr.rms_norm_plain(x, w, eps, policy),
                           flush=flush),
                       "library_ms": _time_ms(
                           lambda: F.rms_norm(x, (H,), w, eps), flush=flush),
                       # a multiply-add and two products an element
                       **_bound(nbytes, 4 * N * H, "float32"),
                       "max_abs_err": err, "share_differing": share,
                       "library_max_abs_err": (lib.float() - want.float())
                       .abs().max().item()}
                _log(row)
                results[(policy, N, H, str(dt).split(".")[-1])] = row
    # a row stride: every other row of a [16, 4096] tensor
    base = torch.randn((16, 4096), generator=gen,
                       device="cuda").to(torch.bfloat16)
    w = torch.ones(4096, dtype=torch.bfloat16, device="cuda")
    for policy in fnr.POLICIES:
        got, rstd = fnr.rms_norm(base[::2], w, eps, policy)
        want, want_rstd = fnr.rms_norm_plain(base[::2], w, eps, policy)
        _rms_errors(got, want, rstd, want_rstd)
    _log({"phase": "kernel_rms_strided", "shape": "every other row of "
          "[16, 4096] bfloat16", "policies": list(fnr.POLICIES),
          "within_limits": True})
    del flush
    torch.cuda.empty_cache()
    return results


def _llama_prompt_lens(rng):
    """The slot loop's 8 prompt lengths in 32..700 (the first draw of
    ``rng``, as the GPT serving workload draws its lengths)."""
    return [int(n) for n in rng.integers(32, 701, 8)]


def llama_kernel_phase(fa, fd):
    """The two attention kernels of the LLaMA path at the shapes llama_7b
    gives them (32 heads of 128, bf16, q, k and v each a contiguous
    tensor as the rope and the v projection leave them), held per element
    to their plain versions at the limits of the GPT shapes:
    ``flash_attention_fwd`` at generate's prefill (B 4, S 512, causal);
    ``flash_decode`` at the slot loop's decode step (B 8, T 1024, ragged
    positions) and at its ``prefill_into_slots`` of the longest prompt
    (B 1, W = T = its length less one, pos 0: the window attends its own
    fresh K/V).  Times beside the plain versions, SDPA and the bound."""
    W = max(_llama_prompt_lens(np.random.default_rng(0))) - 1
    bf = torch.bfloat16
    rows = kernel_phase(fd, [
        ("llama_decode", 8, 1, 1024, 32, 32, bf, "ragged", False),
        ("llama_prefill_into_slots", 1, W, W, 32, 32, bf, "zero", False)],
        phase="kernel_llama")
    results = {r["name"]: r for r in rows}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    B, S, nH, hD = 4, 512, 32, 128
    q, k, v = (torch.randn((B, S, nH, hD), generator=gen, device="cuda")
               .to(bf) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0)
    err, ref_max, differ, share = _err(out, w_out)
    lse_err = (lse - w_lse).abs().max().item()
    if not share <= 1 or not lse_err <= 1e-3:
        raise AssertionError(f"flash_attention_fwd llama_prefill: max abs err "
                             f"{err}, {share} of its limit; lse {lse_err}")
    sdpa = [t.transpose(1, 2) for t in (q, k, v)]
    lib_err = (F.scaled_dot_product_attention(*sdpa, is_causal=True)
               .transpose(1, 2).float() - w_out.float()).abs().max().item()
    n_el, stats = B * S * nH * hD, B * nH * S * 4
    row = {"phase": "kernel_llama", "name": "llama_prefill",
           "shape": f"B={B} S={S} nH={nH} hD={hD} bfloat16 causal, "
                    f"unpacked q/k/v",
           "kernel_ms": _time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                                True),
                                 reps=10, flush=flush),
           "plain_ms": _time_ms(
               lambda: fa.flash_attention_with_lse_plain(q, k, v, 0), reps=3,
               flush=flush),
           "library_ms": _time_ms(
               lambda: F.scaled_dot_product_attention(*sdpa, is_causal=True),
               reps=10, flush=flush),
           **_bound(4 * n_el * 2 + stats,
                    4 * hD * (S * (S + 1) // 2) * B * nH, "bfloat16"),
           "max_abs_err": err, "max_ref": ref_max, "share_differing": differ,
           "limit_share": share, "lse_max_abs_err": lse_err,
           "library_max_abs_err": lib_err}
    row.update(_rates({"fwd_ms": row["kernel_ms"]}, {"fwd": row}))
    _log(row)
    results["llama_prefill"] = row
    del flush, q, k, v, out, lse, w_out, w_lse, sdpa
    torch.cuda.empty_cache()
    return results


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def llama_slot_loop(llama, params, cfg, prompts, new_tokens, max_len,
                    kv_dtype="bf16", attn_kernel=None, device="cuda"):
    """The serving engine's slot priming, written out for LLaMA: each
    prompt but its last token goes through ``prefill_into_slots`` into
    its own slot; one ``decode_step_multi`` at each slot's position S-1
    feeds the last prompt token (the first new token), and new_tokens - 1
    greedy steps follow.  Returns a dict: the streams [B][new_tokens],
    the first step's logits, the cache and the last step's token and
    positions (for a profile), and host seconds of the prefills and of
    the decode steps (each section ends in a synchronise)."""
    cache = llama.init_decode_cache(cfg, len(prompts), max_len, kv_dtype,
                                    device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b, p in enumerate(prompts):
            ids = torch.as_tensor(np.asarray(p[:-1]), device=device)[None]
            llama.prefill_into_slots(params, ids, cfg, cache,
                                     torch.tensor([b], device=device),
                                     attn_kernel=attn_kernel)
        _sync(device)
        t1 = time.perf_counter()
        tok = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32,
                           device=device)
        pos = torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32,
                           device=device)
        out, first = [], None
        for i in range(new_tokens):
            if i:
                pos = pos + 1
            logits, cache = llama.decode_step_multi(
                params, cache, tok, pos, cfg, attn_kernel=attn_kernel)
            if first is None:
                first = logits
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        streams = torch.stack(out, 1).cpu().tolist()
        t2 = time.perf_counter()
    return {"streams": streams, "first_logits": first, "cache": cache,
            "token": tok, "pos": pos, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def _rms_launches(cfg, forwards, into_slots):
    """RMS "llama" launches of a run: 2L + 1 a forward pass (a prefill,
    a decode step), 2L a ``prefill_into_slots`` call (no final norm)."""
    L = cfg.num_layers
    return (2 * L + 1) * forwards + 2 * L * into_slots


def llama_reference_phase(llama, fnr, fd):
    """llama_tiny (4 q / 2 kv heads, hD 32) in float32 at
    initializer_range 0.3 (0.02 gives near-constant streams that would
    hide a broken cache): the card's kernel route (use_flash None: the
    RMS kernel, flash_attention; attn_kernel "flash") against the CPU's
    plain route, identical greedy streams for ``generate`` (B 2, S 16,
    8 new) and for the slot loop over 4 prompts of different lengths at
    kv_dtype bf16 and int8; the card's launches counted exactly."""
    cfg = llama.llama_tiny(dtype=torch.float32, initializer_range=0.3)
    cpu_params = llama.init_params(cfg, seed=1, device="cpu")
    gpu_params = _to_device(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 16))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 23, 12, 40)]
    gen = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        fnr.reset_launches()
        gen[dev] = llama.generate(params, ids, cfg, max_new_tokens=8).cpu() \
            .tolist()
    want = _rms_launches(cfg, 8, 0)
    if gen["cpu"] != gen["cuda"] or fnr.LAUNCHES["llama"] != want:
        raise AssertionError(f"llama_tiny generate: card {gen['cuda']} vs "
                             f"CPU {gen['cpu']}, {fnr.LAUNCHES} RMS launches "
                             f"(want {want})")
    loops = {}
    for kd in ("bf16", "int8"):
        cpu = llama_slot_loop(llama, cpu_params, cfg, prompts, 8, 64, kd,
                              "xla", "cpu")
        fnr.reset_launches()
        fd.reset_launches()
        card = llama_slot_loop(llama, gpu_params, cfg, prompts, 8, 64, kd,
                               "flash", "cuda")
        counts = (fnr.LAUNCHES["llama"], fd.LAUNCHES)
        want = (_rms_launches(cfg, 8, len(prompts)),
                cfg.num_layers * (8 + len(prompts)))
        if card["streams"] != cpu["streams"] or counts != want:
            raise AssertionError(f"llama_tiny slot loop {kd}: card "
                                 f"{card['streams']} vs CPU {cpu['streams']}, "
                                 f"launches {counts} (want {want})")
        loops[kd] = card["streams"]
    _log({"phase": "reference_llama", "config": "llama_tiny f32, GQA 4/2, "
          "initializer_range 0.3", "generate": gen["cuda"],
          "slot_loop_prompt_lens": [len(p) for p in prompts],
          "slot_loop_kv_dtypes": sorted(loops), "streams_identical": True})


@contextlib.contextmanager
def _patched(module, name, fault):
    """``module.name`` replaced by ``fault(module.name)`` for the block."""
    old = getattr(module, name)
    setattr(module, name, fault(old))
    try:
        yield
    finally:
        setattr(module, name, old)


# Negative controls of the full-width route check: each is the kernel
# route with one fault of the kind a kernel could have, injected at run
# time around the call (the sources are not touched).  Attention faults
# wrap the attention kernel's wrapper (``flash_attention`` in prefill,
# ``flash_decode_attention`` in decode); the RMS fault wraps ``rms_norm``.
def _kv_heads_rolled(attn):
    """Every head attends the K/V of its neighbour (a head-index
    fault)."""
    def f(q, k, v, *a, **kw):
        return attn(q, k.roll(1, 2), v.roll(1, 2), *a, **kw)
    return f


def _attention_zeroed(attn):
    """The attention output is never written (zeros)."""
    def f(q, k, v, *a, **kw):
        return torch.zeros_like(q)
    return f


def _newest_row_dropped(attn):
    """flash_decode attends rows [0, pos) instead of [0, pos] (an
    off-by-one mask)."""
    def f(q, k, v, pos):
        return attn(q, k, v, pos - 1)
    return f


def _first_rms_fused(rms):
    """The first RMSNorm of the call (layer 0's attention norm) runs in
    the "fused" rounding policy (a rounding-point fault)."""
    calls = [0]

    def f(x, w, eps, policy):
        calls[0] += 1
        return rms(x, w, eps, "fused" if calls[0] == 1 else policy)
    return f


def _controls(llama, common, run, decode):
    """``run()`` (one kernel-route step's logits) under each negative
    control: the attention faults on the kernel that step runs
    (``decode``: flash_decode, else flash_attention), and the RMS
    fault."""
    attn = (llama, "flash_decode_attention") if decode \
        else (common, "flash_attention")
    faults = [("kv_heads_rolled", attn, _kv_heads_rolled),
              ("attention_zeroed", attn, _attention_zeroed),
              ("first_rms_fused", (llama, "rms_norm"), _first_rms_fused)]
    if decode:
        faults.append(("newest_row_dropped", attn, _newest_row_dropped))
    out = {}
    for name, (module, attr), fault in faults:
        with _patched(module, attr, fault), torch.inference_mode():
            out[name] = run()
    return out


def llama_serving_phase(llama, common, fnr, fa, fd):
    """llama_7b at full width (32 layers, H 4096, 32 heads of 128, FFN
    11008, V 32000, bf16, random weights from seed 0).  (a) ``generate``
    of 4 seeded prompts of 512 tokens, 32 new, greedy; (b) the slot loop
    over 8 prompts (lengths from seed 0 in 32..700), max_len 1024, 32
    new tokens, attn_kernel "flash".  Counts are set to 0 just before
    each and held exactly: RMS "llama" 65 a forward pass and 64 a
    ``prefill_into_slots``, flash_attention_fwd 32 a generate prefill,
    flash_decode 32 a slot decode step and a ``prefill_into_slots``.
    Then one 8-slot decode step profiled; the plain route (use_flash
    False, attn_kernel "xla") on the same weights and prompts, its
    stream agreement reported; and the first-step logits of both routes
    (generate's prefill, the slot loop's first step) against the same
    steps computed in float32 from the same weights (``_route_cmp``)."""
    cfg = llama.llama_7b(dtype=torch.bfloat16)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _log({"phase": "llama_setup", "config": "llama_7b bf16",
          "params": llama.param_count(params),
          "init_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    rng = np.random.default_rng(0)
    B, S, new = 4, 512, 32
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                       device="cuda")
    # warm-up: cuBLAS handles and each kernel's first launch
    llama.generate(params, ids[:, :16], cfg, max_new_tokens=2)
    torch.cuda.synchronize()

    def counts():
        return {"rms_llama": fnr.LAUNCHES["llama"],
                "rms_fused": fnr.LAUNCHES["fused"],
                "flash_attention_fwd": fa.LAUNCHES["flash_attention_fwd"],
                "flash_decode": fd.LAUNCHES}

    def reset():
        fnr.reset_launches()
        fd.reset_launches()
        fa.reset_launches()

    reset()
    t0 = time.perf_counter()
    toks = llama.generate(params, ids, cfg, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = counts()
    want = {"rms_llama": _rms_launches(cfg, new, 0), "rms_fused": 0,
            "flash_attention_fwd": L, "flash_decode": 0}
    if gen_counts != want:
        raise AssertionError(f"llama_7b generate launches {gen_counts}, "
                             f"want {want}")
    toks = toks.cpu()
    if toks.shape != (B, new) or not bool(((toks >= 0)
                                           & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"llama_7b generate tokens {toks}")
    with torch.inference_mode():
        cache = llama.init_decode_cache(cfg, B, S + new, device="cuda")
        first = {"kernel": llama.prefill(params, ids, cfg, cache)[0]}
        prefill_ms = _time_ms(lambda: llama.prefill(params, ids, cfg, cache),
                              reps=3)
        first["plain"] = llama.prefill(params, ids, plain_cfg, cache)[0]
        first["controls"] = _controls(
            llama, common, lambda: llama.prefill(params, ids, cfg, cache)[0],
            decode=False)
        del cache
    plain_toks = llama.generate(params, ids, plain_cfg,
                                max_new_tokens=new).cpu()
    gen_row = {"phase": "llama_generate", "B": B, "S": S, "max_new": new,
               "launches": gen_counts, "wall_s": gen_s,
               "prefill_ms": prefill_ms,
               # decode: the wall time less one prefill's device time
               "decode_tok_s": B * (new - 1) / (gen_s - prefill_ms / 1e3),
               "e2e_tok_s": B * new / gen_s,
               "plain_route_streams_equal":
                   f"{sum(a == b for a, b in zip(toks.tolist(), plain_toks.tolist()))}/{B}",
               "plain_route_tokens_equal":
                   f"{int((toks == plain_toks).sum())}/{B * new}"}

    # (b) the slot loop over 8 prompts of seeded lengths
    rng = np.random.default_rng(0)
    lens = _llama_prompt_lens(rng)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    torch.cuda.reset_peak_memory_stats()
    reset()
    loop = llama_slot_loop(llama, params, cfg, prompts, new, 1024,
                           attn_kernel="flash")
    loop_counts = counts()
    want = {"rms_llama": _rms_launches(cfg, new, len(prompts)),
            "rms_fused": 0, "flash_attention_fwd": 0,
            "flash_decode": L * (new + len(prompts))}
    if loop_counts != want:
        raise AssertionError(f"llama_7b slot loop launches {loop_counts}, "
                             f"want {want}")
    cache = loop.pop("cache")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    peak = torch.cuda.max_memory_allocated()
    prof = _step_profile(lambda: llama.decode_step_multi(
        params, cache, loop["token"], loop["pos"], cfg, attn_kernel="flash"),
        LLAMA_FAMILIES)
    # the first step again on the final cache (rows past S-1 are masked,
    # row S-1 is rewritten before it is read), then under each control
    first_tok = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32,
                             device="cuda")
    first_pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                             device="cuda")

    def first_step():
        return llama.decode_step_multi(params, cache, first_tok, first_pos,
                                       cfg, attn_kernel="flash")[0]

    with torch.inference_mode():
        again = first_step()
    loop_controls = _controls(llama, common, first_step, decode=True)
    del cache
    torch.cuda.empty_cache()
    plain = llama_slot_loop(llama, params, plain_cfg, prompts, new, 1024,
                            attn_kernel="xla")
    del plain["cache"]
    same = sum(a == b for a, b in zip(loop["streams"], plain["streams"]))
    tokens_same = sum(x == y for a, b in zip(loop["streams"], plain["streams"])
                      for x, y in zip(a, b))
    loop_row = {"phase": "llama_slot_loop", "prompt_lens": lens,
                "max_len": 1024, "new_tokens": new, "launches": loop_counts,
                "prefill_s": loop["prefill_s"], "decode_s": loop["decode_s"],
                "decode_tok_s": len(prompts) * new / loop["decode_s"],
                "cache_bytes": cache_bytes, "peak_memory_bytes": peak,
                "plain_route_streams_equal": f"{same}/{len(prompts)}",
                "plain_route_tokens_equal":
                    f"{tokens_same}/{len(prompts) * new}",
                "decode_step": dict(slots=len(prompts),
                                    tok_s=len(prompts) / prof["wall_ms"] * 1e3,
                                    **prof)}
    torch.cuda.empty_cache()

    # the first steps again in float32 (the same weights widened, plain
    # compositions, TF32 off): the yardstick both bf16 routes are held to
    f32 = _cast(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, use_flash=False)
    with torch.inference_mode():
        cache = llama.init_decode_cache(cfg32, B, S + new, device="cuda")
        ref_gen = llama.prefill(f32, ids, cfg32, cache)[0]
        del cache
    ref_loop = llama_slot_loop(llama, f32, cfg32, prompts, 1, 1024,
                               attn_kernel="xla")
    del f32, ref_loop["cache"]
    torch.cuda.empty_cache()
    gen_row.update(_route_cmp(first["kernel"], first["plain"], ref_gen,
                              "prefill", first["controls"]))
    loop_row.update(_route_cmp(loop["first_logits"], plain["first_logits"],
                               ref_loop["first_logits"], "first_step",
                               loop_controls))
    loop_row["first_step_recomputed_max_abs_diff"] = \
        (again - loop["first_logits"]).abs().max().item()
    _log(gen_row)
    _log(loop_row)
    return gen_row, loop_row


def _cast(tree, dtype):
    """A parameter tree with every floating leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _route_cmp(kernel, plain, ref, label, controls):
    """The bf16 kernel route's first-step logits against the same step in
    float32 (``ref``), per element: |kernel - ref| within
    LLAMA_ROUTE_FACTOR times the plain bf16 route's largest |plain - ref|
    (the size of bf16 rounding through the stack, measured on the same
    inputs); the two routes round P, and sum, in other places, so their
    difference alone has no fixed size.  Raises past the bound.  Each
    negative control (the kernel route with one injected fault) is read
    against the same float32 step and reported beside the bound: the
    largest and the mean |control - ref|, a non-finite control as inf.
    Raises too if an attention-fault control (LLAMA_MUST_FAIL) stays
    within the bound: then the bound could not tell a broken route."""
    for name, t in (("kernel", kernel), ("plain", plain), ("f32", ref)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"llama_7b {label}: non-finite {name} logits")

    def dist(t):
        d = (t.float() - ref).abs()
        if not torch.isfinite(d).all():
            return float("inf"), float("inf")
        return d.max().item(), d.mean().item()

    ek, mk = dist(kernel)
    ep, mp = dist(plain)
    bound = LLAMA_ROUTE_FACTOR * ep
    if not ek <= bound:
        raise AssertionError(f"llama_7b {label}: kernel route {ek} from the "
                             f"float32 step, > {LLAMA_ROUTE_FACTOR} x the "
                             f"plain route's {ep}")

    def agree(a):
        return f"{int((a.argmax(-1) == ref.argmax(-1)).sum())}/{ref.shape[0]}"

    ctl = {}
    for name, t in controls.items():
        m, a = dist(t)
        ctl[name] = {"max_abs": m, "mean_abs": a, "max_over_bound": m / bound,
                     "mean_over_plain_mean": a / mp,
                     "argmax_agree_f32": agree(t)}
        if name in LLAMA_MUST_FAIL and not m > bound:
            raise AssertionError(f"llama_7b {label}: control {name} is "
                                 f"{m} from the float32 step, within the "
                                 f"bound {bound}")
    return {f"{label}_kernel_vs_f32_max_abs": ek,
            f"{label}_plain_vs_f32_max_abs": ep,
            f"{label}_kernel_vs_f32_mean_abs": mk,
            f"{label}_plain_vs_f32_mean_abs": mp,
            f"{label}_kernel_vs_plain_max_abs":
                (kernel - plain).abs().max().item(),
            f"{label}_bound": bound,
            f"{label}_logit_std_f32": ref.std().item(),
            f"{label}_argmax_agree_kernel_f32": agree(kernel),
            f"{label}_argmax_agree_plain_f32": agree(plain),
            f"{label}_controls": ctl}


# ---------------------------------------------------------------------------
# LLaMA training and the ring variant of flash attention
# ---------------------------------------------------------------------------

RING_P = 4                          # ranks of the replayed ring
RING_CHUNK = 1024                   # llama_7b's 4096 positions over 4 ranks
RING_OFFSETS = (-1024, -37, 0, 37, 1024, 3072)
RING_TRAIN_OFFSETS = (0, -37, 37)   # at the sp run's [B, S] (offset 0 there)
RING_LSE_ATOL = 1e-3
# the replayed ring against dense flash attention over the whole
# sequence: float32 within F32_REL of the largest value; bfloat16 (each
# rank's partials rounded to bf16 by the kernel, dK/dV summed across ranks
# in bf16, as in JAX) within 2^-6 in norm and 2^-4 of the largest value
RING_BF16_NORM_REL, RING_BF16_MAX_REL = 2 ** -6, 2 ** -4
SP_LOSS_REL = 1e-6                  # one-rank ring vs no group: loss
SP_GRAD_NORM_REL = 1e-3             # and each gradient leaf, in norm
LLAMA_TRAIN_LAYERS = 8              # llama_7b's 32, cut to fit AdamW state
LLAMA_TRAIN_B, LLAMA_TRAIN_S = 4, 2048
LLAMA_FLASH_FAMILIES = (("flash_fwd", ("flash_attention_fwd",)),
                        ("flash_bwd", ("flash_attention_bwd",)),
                        ("rms_fwd", ("rms_norm",)))


def _visible_pairs(Sq, Sk, offset):
    """(query, key) pairs with j <= i + offset, per (batch, head)."""
    i = np.arange(Sq)
    return int(np.clip(i + offset + 1, 0, Sk).sum())


def _visible(Sq, Sk, offset, device):
    """[Sq, Sk] bool: key j visible to query i iff j <= i + offset."""
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None] + offset)


RING = "flash_attention_with_lse"    # the ring variant's launch counts


def ring_kernels_check(fa, q, k, v, dout, g_lse, offset):
    """The offset variant's three kernels (counted under the ring entry)
    against their plain versions on the same inputs (the backward pair
    reads the kernel's lse and a delta that folds in the lse cotangent),
    per element at the training phase's limits, lse at RING_LSE_ATOL;
    and at offset 0 the same three kernels under ``flash_attention``'s
    entry, as its autograd Function launches them, bit for bit.  Raises
    past a limit; returns (kernel outputs (out, lse, dk, dv, dq), delta,
    errors, lse error)."""
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, offset, RING)
    delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, True,
                                        None, offset, RING)
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, True, None,
                                   offset, RING)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, offset)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                                  True, None, offset)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, True,
                                           None, offset)
    errs = {"out": _err(out, w_out), "dk": _err(dk, w_dk),
            "dv": _err(dv, w_dv), "dq": _err(dq, w_dq)}
    lse_err = (lse - w_lse).abs().max().item()
    label = f"offset {offset} {q.dtype} {tuple(q.shape)}"
    for key, (err, _, _, share) in errs.items():
        if not share <= 1:
            raise AssertionError(f"flash_attention offset kernels {label} "
                                 f"{key}: max abs err {err}, {share} of "
                                 f"its limit")
    if not lse_err <= RING_LSE_ATOL:
        raise AssertionError(f"flash_attention offset kernels {label} lse: "
                             f"{lse_err}")
    if offset == 0:
        z_out, z_lse = fa.flash_attention_fwd(q, k, v, True)
        z_dk, z_dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta)
        z_dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta)
        for name, a, b in (("out", out, z_out), ("lse", lse, z_lse),
                           ("dk", dk, z_dk), ("dv", dv, z_dv),
                           ("dq", dq, z_dq)):
            if not torch.equal(a, b):
                raise AssertionError(f"offset 0 vs the zero-offset kernel "
                                     f"{label} {name}: not bit for bit")
    return (out, lse, dk, dv, dq), delta, errs, lse_err


def ring_kernel_phase(fa):
    """The offset variant at llama_7b's attention per ring chunk (B 1,
    1024 queries and keys, 32 heads of 128, causal), bfloat16 and
    float32, at offsets -1024 (every row fully masked: the kernels visit
    every key tile, as the TPU kernel does), -37, 0, 37, 1024 and 3072
    (every key visible); and at the shape the sequence-parallel run
    gives it (llama_7b training, B 4, S 2048, bf16) at offsets 0 (that
    run's), -37 and 37.  Each held per element to the plain versions,
    offset 0 bit for bit to the zero-offset entry.  Times of the kernels
    and the plain versions; SDPA with the offset's boolean mask, forward
    and autograd backward, at offsets >= 0 (a fully masked row gives NaN
    there); bounds from the visible pairs (bytes where none is)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    nH, hD = 32, 128
    cases = [("chunk", 1, RING_CHUNK, torch.bfloat16, RING_OFFSETS),
             ("chunk", 1, RING_CHUNK, torch.float32, RING_OFFSETS),
             ("train", LLAMA_TRAIN_B, LLAMA_TRAIN_S, torch.bfloat16,
              RING_TRAIN_OFFSETS)]
    results = {}
    for case, B, S, dt, offsets in cases:
        dts = str(dt).split(".")[-1]
        q, k, v, dout = (torch.randn((B, S, nH, hD), generator=gen,
                                     device="cuda").to(dt) for _ in range(4))
        g_lse = torch.randn((B, nH, S), generator=gen, device="cuda")
        for off in offsets:
            (out, lse, *_), delta, errs, lse_err = ring_kernels_check(
                fa, q, k, v, dout, g_lse, off)
            times = {
                "fwd_ms": _time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, True, None, off, RING), reps=10, flush=flush),
                "fwd_plain_ms": _time_ms(
                    lambda: fa.flash_attention_with_lse_plain(q, k, v, off),
                    reps=3, flush=flush),
                "dkv_ms": _time_ms(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, dout, lse, delta, True, None, off, RING),
                    reps=10, flush=flush),
                "dkv_plain_ms": _time_ms(
                    lambda: fa.flash_attention_bwd_dkv_plain(
                        q, k, v, dout, lse, delta, True, None, off), reps=3,
                    flush=flush),
                "dq_ms": _time_ms(lambda: fa.flash_attention_bwd_dq(
                    q, k, v, dout, lse, delta, True, None, off, RING),
                    reps=10, flush=flush),
                "dq_plain_ms": _time_ms(
                    lambda: fa.flash_attention_bwd_dq_plain(
                        q, k, v, dout, lse, delta, True, None, off), reps=3,
                    flush=flush),
                "fwd_library_ms": None, "bwd_library_ms": None}
            lib_err = None
            if off >= 0:
                mask = _visible(S, S, off, "cuda")
                leaves = [t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         attn_mask=mask)
                lib_err = (lib_out.detach().transpose(1, 2).float()
                           - out.float()).abs().max().item()
                times["fwd_library_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *(t.transpose(1, 2) for t in (q, k, v)),
                        attn_mask=mask), reps=10, flush=flush)
                times["bwd_library_ms"] = _time_ms(
                    lambda: torch.autograd.grad(
                        lib_out, leaves, dout.transpose(1, 2),
                        retain_graph=True), reps=10, flush=flush)
                del lib_out, leaves, mask
            if case == "train" and off == 0:
                # the same function through SDPA's causal flag: its flash
                # backend, where the boolean mask above takes another
                leaves = [t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         is_causal=True)
                times["fwd_library_causal_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *(t.transpose(1, 2) for t in (q, k, v)),
                        is_causal=True), reps=10, flush=flush)
                times["bwd_library_causal_ms"] = _time_ms(
                    lambda: torch.autograd.grad(
                        lib_out, leaves, dout.transpose(1, 2),
                        retain_graph=True), reps=10, flush=flush)
                del lib_out, leaves
            pairs = _visible_pairs(S, S, off) * B * nH
            n_el, e, stats = B * S * nH * hD, q.element_size(), B * nH * S * 4
            bounds = {
                "fwd": _bound(4 * n_el * e + stats, 4 * hD * pairs, dts),
                "dkv": _bound(6 * n_el * e + 2 * stats, 8 * hD * pairs, dts),
                "dq": _bound(5 * n_el * e + 2 * stats, 6 * hD * pairs, dts)}
            row = {"phase": "kernel_ring", "case": case, "offset": off,
                   "shape": f"B={B} Sq=Sk={S} nH={nH} hD={hD} {dts} causal",
                   "visible_pairs": pairs, **times, **_rates(times, bounds),
                   "max_abs_err": {k2: v2[0] for k2, v2 in errs.items()},
                   "limit_share": {k2: v2[3] for k2, v2 in errs.items()},
                   "lse_max_abs_err": lse_err,
                   "library_fwd_max_abs_err": lib_err,
                   "offset0_bit_for_bit": True if off == 0 else None,
                   "bounds": bounds}
            _log(row)
            results[(f"{case} {dts}", off)] = row
            del out, lse, delta
        del q, k, v, dout, g_lse
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return results


def _replay_pass(kc, vc, rank):
    """The hand-over of rank ``rank`` in a replayed ring: each call
    returns the chunk one rank further back than the last one."""
    held = iter(range(rank - 1, rank - len(kc), -1))

    def pass_kv(_k, _v):
        src = next(held) % len(kc)
        return kc[src], vc[src]
    return pass_kv


def ring_replay(fa, ra, B, Sl, nH, hD, dtype, seed=0, timed=False):
    """All RING_P ranks of a ring over a sequence of RING_P * Sl, replayed
    on one card through ``ring_attention_loop`` with a local hand-over:
    the concatenated outputs and dq/dk/dv from one backward against
    dense ``flash_attention`` over the whole sequence (float32 within
    F32_REL of the largest value; bfloat16 within RING_BF16_NORM_REL in
    norm and RING_BF16_MAX_REL of the largest value).  Raises past a
    limit; returns a row of errors (and times of both, fwd + bwd)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (B, RING_P * Sl, nH, hD)
    base = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]
    g = base[3]

    def replay():
        leaves = [t.detach().requires_grad_(True) for t in base[:3]]
        qc, kc, vc = (t.chunk(RING_P, dim=1) for t in leaves)
        out = torch.cat([ra.ring_attention_loop(
            qc[r], kc[r], vc[r], r, RING_P, _replay_pass(kc, vc, r))
            for r in range(RING_P)], dim=1)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    def dense():
        leaves = [t.detach().requires_grad_(True) for t in base[:3]]
        out = fa.flash_attention(*leaves)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    fa.reset_launches()
    got = replay()
    torch.cuda.synchronize()
    launches = fa.launches(RING)
    want = dense()
    row = {"shape": f"{RING_P} ranks x B={B} S={Sl} nH={nH} hD={hD} "
                    f"{str(dtype).split('.')[-1]}", "launches": launches}
    if launches != {n: RING_P * RING_P for n in launches}:
        raise AssertionError(f"ring replay launches {launches}: want "
                             f"{RING_P * RING_P} of each (every block)")
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        diff = (a.float() - b.float())
        ref = b.float().abs().max().item()
        err, norm_rel = diff.abs().max().item(), (
            diff.norm() / b.float().norm()).item()
        row[name] = {"max_abs_err": err, "max_ref": ref, "norm_rel": norm_rel}
        if dtype == torch.float32:
            ok = err <= F32_REL * max(1.0, ref)
        else:
            ok = norm_rel <= RING_BF16_NORM_REL \
                and err <= RING_BF16_MAX_REL * ref
        if not ok:
            raise AssertionError(f"ring replay {row['shape']} {name}: "
                                 f"{row[name]}")
    if timed:
        row["replay_ms"] = _time_ms(replay, reps=5)
        row["dense_ms"] = _time_ms(dense, reps=5)
    return row


def ring_replay_phase(fa, ra):
    """The replayed 4-way ring at llama_7b's shapes (chunks of 1024,
    global S 4096, 32 heads of 128), float32 and bfloat16, timed beside
    dense flash attention (forward and backward)."""
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        row = ring_replay(fa, ra, 1, RING_CHUNK, 32, 128, dt, timed=True)
        row["phase"] = "ring_replay"
        _log(row)
        rows[str(dt).split(".")[-1]] = row
    torch.cuda.empty_cache()
    return rows


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _grad_leaves(params):
    """(names, leaves) of a parameter tree, each leaf made trainable."""
    named = _named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    return [n for n, _ in named], [t for _, t in named]


def llama_sp_check(llama, fa, cfg, params, ids, labels):
    """``llama.loss_fn(sp_group=g)`` on a real one-rank NCCL group (the
    ring at P = 1: one block at offset 0 through the offset kernels, no
    exchange) against ``loss_fn`` without a group on the same params and
    batch: the loss within SP_LOSS_REL, each gradient leaf within
    SP_GRAD_NORM_REL in norm (bit for bit is reported).  A first call
    sets up the NCCL communicator; the kernels' counts are reset just
    before the second and read just after, and it alone is timed."""
    import torch.distributed as dist
    names, leaves = _grad_leaves(params)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)

    def sp_loss_and_grads():
        loss = llama.loss_fn(params, ids, labels, cfg, sp_group=group)
        return loss, torch.autograd.grad(loss, leaves)

    try:
        group = dist.new_group([0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp_loss_and_grads()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        fa.reset_launches()
        t0 = time.perf_counter()
        loss_sp, g_sp = sp_loss_and_grads()
        torch.cuda.synchronize()
        sp_ms = (time.perf_counter() - t0) * 1e3
        launches = fa.launches(RING)
        zero_offset = fa.launches()
        loss = llama.loss_fn(params, ids, labels, cfg)
        g = torch.autograd.grad(loss, leaves)
    finally:
        dist.destroy_process_group()
    rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, g_sp, g)}
    row = {"loss_sp": loss_sp.item(), "loss": loss.item(),
           "loss_bit_for_bit": bool(torch.equal(loss_sp, loss)),
           "grads_bit_for_bit": all(torch.equal(a, b)
                                    for a, b in zip(g_sp, g)),
           "grad_norm_rel_max": max(rel.values()), "offset_launches": launches,
           "zero_offset_launches": zero_offset,
           "first_call_ms": first_ms, "sp_loss_and_grads_ms": sp_ms}
    L = cfg.num_layers
    if launches != {n: L for n in launches} or any(zero_offset.values()):
        raise AssertionError(f"llama sp launches: offset {launches} (want "
                             f"{L} each), zero-offset {zero_offset}")
    if not abs(row["loss_sp"] - row["loss"]) <= SP_LOSS_REL * abs(
            row["loss"]) or not row["grad_norm_rel_max"] <= SP_GRAD_NORM_REL:
        raise AssertionError(f"llama sp at P = 1 vs no group: {row}, {rel}")
    return row


def _llama_train_counts(fa, fnr):
    return {**fa.launches(), "ring": sum(fa.launches(RING).values()),
            "rms_llama": fnr.LAUNCHES["llama"]}


def _llama_train_want(L, steps, remat):
    """Launches of ``steps`` LLaMA train steps: each flash kernel L a
    step (the forward 2L under remat), RMS "llama" 2L + 1 a forward pass
    (2L more under remat: the layers run again in the backward)."""
    return {"flash_attention_fwd": steps * L * (2 if remat else 1),
            "flash_attention_bwd_dkv": steps * L,
            "flash_attention_bwd_dq": steps * L, "ring": 0,
            "rms_llama": steps * (2 * L + 1 + (2 * L if remat else 0))}


def llama_train_reference_phase(llama, hybrid, fa, fnr):
    """llama_tiny (GQA 4/2) float32: three train steps on the card (the
    flash and RMS kernels) against the CPU (plain versions) on the same
    weights and batch, at remat False and True: losses at rel 1e-4,
    launches exact."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    ids, labels = (torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
                   for _ in range(2))
    rows = []
    for remat in (False, True):
        losses = {}
        for dev in ("cpu", "cuda"):
            step, shard, init_opt = hybrid.build_train_step(
                cfg, device=dev, model=hybrid.llama_stage_model(cfg, remat))
            p = shard(params)
            o = init_opt(p)
            fa.reset_launches()
            fnr.reset_launches()
            out = []
            for _ in range(3):
                loss, p, o = step(p, o, ids.to(dev), labels.to(dev))
                out.append(loss.item())
            losses[dev] = out
            counts = _llama_train_counts(fa, fnr)
            want = (_llama_train_want(cfg.num_layers, 3, remat)
                    if dev == "cuda" else dict.fromkeys(counts, 0))
            if counts != want:
                raise AssertionError(f"llama train reference {dev} remat "
                                     f"{remat}: launches {counts} != {want}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        row = {"phase": "reference_llama_training",
               "config": "llama_tiny f32, GQA 4/2", "remat": remat,
               "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
               "max_rel_diff": rel, "rtol": 1e-4,
               "launches_card": _llama_train_want(cfg.num_layers, 3, remat)}
        _log(row)
        if not rel <= 1e-4 or not losses["cuda"][2] < losses["cuda"][0]:
            raise AssertionError(f"llama train reference remat {remat}: card "
                                 f"{losses['cuda']} vs CPU {losses['cpu']}")
        rows.append(row)
    return rows


def rms_backward_check(fnr, x, w, g, policy):
    """``rms_norm`` under autograd on the card (the kernel's forward,
    the policy's plain backward) against the same call on the CPU (the
    plain forward, the same backward) on the same inputs: float32 within
    1e-5 of each gradient's largest value; bfloat16 dw at most one step
    apart per element (a float32 sum rounded once, in another order),
    and so dx, except that the "llama" dx is held within one step of the
    larger of the element and twice its first addend |g * w * rstd|: it
    ends in a bfloat16 add of two rounded terms, and where they cancel,
    one step of either is many steps of the sum.  Raises past a limit;
    returns (max |err| of dx, of dw, shares of differing elements)."""
    before = fnr.LAUNCHES[policy]
    grads = []
    for dev in ("cuda", "cpu"):
        xx, ww = (t.detach().to(dev).requires_grad_(True) for t in (x, w))
        fnr.rms_norm(xx, ww, 1e-6, policy)[0].backward(g.to(dev))
        grads.append((xx.grad.cpu(), ww.grad.cpu()))
    if fnr.LAUNCHES[policy] != before + 1:
        raise AssertionError("rms_norm under autograd did not launch its "
                             "kernel once")
    addend = None
    if policy == "llama":
        xc, gc, wc = x.cpu().float(), g.cpu().float(), w.cpu().float()
        addend = 2 * (gc * wc * torch.rsqrt((xc * xc).mean(-1, keepdim=True)
                                             + 1e-6)).abs()
    out = []
    for (got, want), floor in zip(zip(*grads), (addend, None)):
        diff = (got.float() - want.float()).abs()
        if got.dtype == torch.bfloat16:
            scale = torch.maximum(got.float().abs(), want.float().abs())
            if floor is not None:
                scale = torch.maximum(scale, floor)
            ok = bool((diff <= _bf16_step(scale)).all())
        else:
            ok = diff.max().item() <= 1e-5 * want.float().abs().max().item()
        if not ok:
            raise AssertionError(f"rms_norm {policy} backward {got.dtype} "
                                 f"{tuple(x.shape)}, card vs CPU: max abs "
                                 f"err {diff.max().item()}")
        out += [diff.max().item(), (diff > 0).float().mean().item()]
    return out


def llama_train_phase(llama, hybrid, TrainLoop, fa, fnr):
    """llama_7b at full width, depth cut to LLAMA_TRAIN_LAYERS, bf16,
    seed-0 weights, through ``build_train_step(model=llama_stage_model)``
    with float32 AdamW moments: B 4, S 2048, one seeded batch, one warm
    step then 4 under ``TrainLoop(max_inflight=2)`` (every loss finite,
    step 5 below step 1, launches exact, counts reset just before); step
    ms, tokens/s, peak memory, a one-step profile by family and the
    optimizer alone by CUDA events; one ``remat=True`` step; the RMS
    "llama" backward at [B*S, H] against the plain version's autograd.
    First, at the init, the kernel route's loss and gradients against
    the plain compositions' (``use_flash=False``) on one sequence.
    Returns (row, (cfg, params, ids, labels)) for the sequence-parallel
    check."""
    cfg = llama.llama_7b(num_layers=LLAMA_TRAIN_LAYERS, dtype=torch.bfloat16)
    B, S, L = LLAMA_TRAIN_B, LLAMA_TRAIN_S, cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, shard, init_opt = hybrid.build_train_step(
        cfg, device="cuda", model=hybrid.llama_stage_model(cfg, remat=False))
    params = shard(llama.init_params(cfg, seed=0, device="cuda"))
    ids, labels = _train_batch(cfg, B, S)
    torch.cuda.synchronize()
    _log({"phase": "llama_training_setup", "config": "llama_7b bf16, "
          f"{L} of 32 layers", "params": llama.param_count(params),
          "init_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    # the kernel route against the plain compositions (use_flash=False:
    # the masked softmax, which rounds P to bf16, and rms_norm_plain) at
    # the seed-0 init on the batch's first sequence: loss within
    # LOSS_TOL, each gradient leaf within PLAIN_GRAD_REL in norm
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    step_p, _, _ = hybrid.build_train_step(
        plain_cfg, device="cuda",
        model=hybrid.llama_stage_model(plain_cfg, remat=False))
    lf, gf = step.loss_and_grads(params, ids[:1], labels[:1])
    fa.reset_launches()
    fnr.reset_launches()
    lp, gp = step_p.loss_and_grads(params, ids[:1], labels[:1])
    plain_launches = _llama_train_counts(fa, fnr)
    grad_rel = {name: ((a.float() - b.float()).norm()
                       / b.float().norm()).item()
                for (name, a), (_, b) in zip(_named_leaves(gf),
                                             _named_leaves(gp))}
    route = {"phase": "llama_training_plain_route",
             "shape": f"B=1 S={S} (the batch's first sequence)",
             "loss_kernels": lf.item(), "loss_plain": lp.item(),
             "grad_rel_diff": grad_rel, "plain_launches": plain_launches,
             "loss_atol": LOSS_TOL, "grad_rel_tol": PLAIN_GRAD_REL}
    _log(route)
    del gf, gp
    if any(plain_launches.values()) \
            or not abs(lf.item() - lp.item()) <= LOSS_TOL \
            or not max(grad_rel.values()) <= PLAIN_GRAD_REL:
        raise AssertionError(f"llama_7b training, kernel vs plain route: "
                             f"{route}")
    opt = init_opt(params)
    first, params, opt = step(params, opt, ids, labels)      # warm
    torch.cuda.synchronize()
    fa.reset_launches()
    fnr.reset_launches()
    t0 = time.perf_counter()
    loop = TrainLoop(step, max_inflight=2)
    handles = []
    for _ in range(4):
        d, params, opt = loop.step(params, opt, ids, labels)
        handles.append(d)
    loop.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _llama_train_counts(fa, fnr)
    losses = [first.item()] + [float(d) for d in handles]
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        raise AssertionError(f"llama training losses {losses}")
    if launches != _llama_train_want(L, 4, False):
        raise AssertionError(f"llama training launches {launches} != "
                             f"{_llama_train_want(L, 4, False)}")
    step_ms = wall / 4 * 1e3
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(params, opt, ids, labels)

    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(one_step, 1, wall_ms, list(LLAMA_FLASH_FAMILIES),
                    top_n=24)
    # the optimizer alone, on gradients at these params (CUDA events):
    # its kernels are elementwise ones that the profile files under other
    _, grads = step.loss_and_grads(params, ids, labels)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    hybrid.adamw_update(params, grads, opt, hybrid.AdamWConfig())
    b.record()
    torch.cuda.synchronize()
    opt_ms = a.elapsed_time(b)
    del grads
    dev = dict(prof["device_ms"])
    dev["optimizer"] = opt_ms
    dev["other"] = dev["other"] - opt_ms
    row = {"phase": "llama_training",
           "config": f"llama_7b bf16, {L} of 32 layers (depth cut), seed 0",
           "B": B, "S": S, "remat": False, "moments": "float32",
           "plain_route": {k: route[k] for k in (
               "loss_kernels", "loss_plain")},
           "plain_route_grad_rel_max": max(grad_rel.values()),
           "losses": losses, "launches_4_steps": launches,
           "step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3),
           "stall_s": loop.stall_seconds, "peak_memory_bytes": peak,
           "profiled_step_wall_ms": wall_ms, **prof,
           "device_ms_by_family": dev, "adamw_update_ms": opt_ms}
    _log(row)
    # one remat=True step from these params
    step_r, _, _ = hybrid.build_train_step(
        cfg, device="cuda", model=hybrid.llama_stage_model(cfg, remat=True))
    fa.reset_launches()
    fnr.reset_launches()
    t0 = time.perf_counter()
    rl, params, opt = step_r(params, opt, ids, labels)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    remat_launches = _llama_train_counts(fa, fnr)
    rl = rl.item()
    if remat_launches != _llama_train_want(L, 1, True) \
            or not np.isfinite(rl):
        raise AssertionError(f"llama remat step: launches {remat_launches}, "
                             f"loss {rl}")
    row["remat_step"] = {
        "loss": rl, "ms": remat_ms, "launches": remat_launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del opt
    torch.cuda.empty_cache()
    # the RMS "llama" backward at the path's rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    x, g = (torch.randn((B * S, cfg.hidden_size), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * torch.randn((cfg.hidden_size,), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    dx_err, dx_share, dw_err, dw_share = rms_backward_check(fnr, x, w, g,
                                                            "llama")

    def fwd_bwd(fn):
        xx, ww = x.detach().requires_grad_(True), w.detach().requires_grad_(
            True)
        fn(xx, ww, 1e-6, "llama")[0].backward(g)

    row["rms_llama_backward"] = {
        "shape": f"[{B * S}, {cfg.hidden_size}] bfloat16",
        "dx_max_abs_err": dx_err, "dx_share_differing": dx_share,
        "dw_max_abs_err": dw_err, "dw_share_differing": dw_share,
        "reference": "the same call on the CPU",
        "rule": "dw one bf16 step per element; dx one step of max(|dx|, "
                "2 |g w rstd|)",
        "kernel_fwd_plain_bwd_ms": _time_ms(lambda: fwd_bwd(fnr.rms_norm)),
        "plain_autograd_ms": _time_ms(lambda: fwd_bwd(fnr.rms_norm_plain))}
    _log({"phase": "llama_training_remat_and_rms_backward",
          "remat_step": row["remat_step"],
          "rms_llama_backward": row["rms_llama_backward"]})
    del x, g, w
    return row, (cfg, params, ids, labels)


def llama_sp_phase(llama, fa, cfg, params, ids, labels):
    """The sequence-parallel loss of the training config on a one-rank
    NCCL group (``llama_sp_check``); the offset kernels' launches there
    are the kernels line's."""
    row = llama_sp_check(llama, fa, cfg, params, ids, labels)
    row.update(phase="llama_sp", config=f"llama_7b bf16, "
               f"{cfg.num_layers} of 32 layers, B {ids.shape[0]}, "
               f"S {ids.shape[1]}, one-rank NCCL group")
    _log(row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch").is_dir():
        print(f"chip_smoke: no paddle_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.distributed import hybrid
    from paddle_tpu_torch.incubate.nn.kernels import _build
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.kernels import flash_decode as fd
    from paddle_tpu_torch.incubate.nn.kernels import fused_ce as fce
    from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl
    from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope as fnr
    from paddle_tpu_torch.incubate.nn.kernels import ring_attention as ra
    from paddle_tpu_torch.incubate.nn import kv_quant as kvq
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine,
        PagedContinuousBatchingEngine)
    from paddle_tpu_torch.jit.loop import TrainLoop
    from paddle_tpu_torch.models import common, gpt, llama
    from paddle_tpu_torch.models.common import matmul_f32out

    card = _nvidia_smi("name,power.limit")
    print(card, flush=True)
    _log({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})
    t0 = time.perf_counter()
    ptxas = _flash_ptxas_start(_build)
    try:
        libs = _build.build(["flash_decode", "flash_attention", "fused_ce",
                             "fused_decode", "rms_norm"])
    except BaseException:
        ptxas[0].kill()
        ptxas[0].wait()
        raise
    _log({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs.values()]})
    resources = flash_resources(ptxas, _build)
    _log({"phase": "flash_attention_resources", "kernels": resources})

    seconds = {}

    def timed(name, phase, *a):
        """Run one phase and keep its seconds (host clock, synchronised)."""
        t = time.perf_counter()
        out = phase(*a)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    kernels = timed("kernel", kernel_phase, fd)
    paged_kernels = timed("paged_kernel", paged_kernel_phase, fd, kvq)
    train_kernels = timed("train_kernel", train_kernel_phase, fa, fce,
                          matmul_f32out)
    rounding = timed("rounding_witness", rounding_witness_phase, fa)
    timed("reference", reference_phase, gpt, ContinuousBatchingEngine)
    timed("paged_reference", paged_reference_phase, gpt,
          ContinuousBatchingEngine, PagedContinuousBatchingEngine)
    timed("train_reference", train_reference_phase, gpt, hybrid)
    cfg, params, serving, launches, streams = timed(
        "serving", serving_phase, gpt, ContinuousBatchingEngine, fd)
    timed("compare", compare_phase, gpt, cfg, params)
    kv_runs = timed("paged_serving", paged_serving_phase, gpt,
                    ContinuousBatchingEngine, PagedContinuousBatchingEngine,
                    fd, cfg, params, streams)
    timed("paged_compare", paged_compare_phase, gpt, cfg, params)
    qparams = gpt.quantize_decode_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    fused_kernels = timed("fused_kernel", fused_kernel_phase, fdl, kvq, gpt,
                          cfg, qparams)
    timed("fused_reference", fused_reference_phase, gpt, FusedB1Engine, fdl)
    fused_runs, b1_steps = timed(
        "fused_serving", fused_serving_phase, gpt, ContinuousBatchingEngine,
        FusedB1Engine, fd, fdl, cfg, qparams)
    del qparams
    torch.cuda.empty_cache()
    training, fa_launches, ce_launches = timed(
        "training", training_phase, gpt, hybrid, TrainLoop, fa, fce)
    torch.cuda.empty_cache()
    plain_training = timed("plain_training", plain_training_phase, gpt,
                           hybrid, fa, training["losses"])
    # the GPT trees are gone with their phases
    torch.cuda.empty_cache()
    rms_kernels = timed("rms_kernel", rms_kernel_phase, fnr)
    llama_kernels = timed("llama_kernel", llama_kernel_phase, fa, fd)
    timed("llama_reference", llama_reference_phase, llama, fnr, fd)
    llama_gen, llama_loop = timed("llama_serving", llama_serving_phase,
                                  llama, common, fnr, fa, fd)
    torch.cuda.empty_cache()
    ring_kernels = timed("ring_kernel", ring_kernel_phase, fa)
    ring_replays = timed("ring_replay", ring_replay_phase, fa, ra)
    timed("llama_train_reference", llama_train_reference_phase, llama,
          hybrid, fa, fnr)
    llama_train, train_state = timed("llama_train", llama_train_phase, llama,
                                     hybrid, TrainLoop, fa, fnr)
    llama_sp = timed("llama_sp", llama_sp_phase, llama, fa, *train_state)
    del train_state
    torch.cuda.empty_cache()
    _log({"phase": "phase_seconds", **seconds,
          "total_with_build": time.perf_counter() - t0})

    src = "paddle_tpu_torch/incubate/nn/kernels/csrc/"
    ref = "paddle_tpu/incubate/nn/kernels/"
    dec, tr, ce = kernels[0], train_kernels["train"], train_kernels["fused_ce"]
    entries = [{
        "name": "flash_decode", "route": "cuda",
        "source": src + "flash_decode.cu",
        "replaces": ref + "flash_decode.py:67",
        "launches": launches, "max_abs_err": dec["max_abs_err"],
        "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "shape": dec["shape"]}]
    # the paged layout and the quantized modes: launches from the run of
    # the engine and kv_dtype that serves them
    for name, case, line, run, key in (
            ("flash_decode_paged", "paged_decode", 253, ("paged", "bf16"),
             "paged"),
            ("flash_decode_paged_int8", "paged_decode_int8", 84,
             ("paged", "int8"), "paged"),
            ("flash_decode_paged_fp8", "paged_decode_fp8", 84,
             ("paged", "fp8"), "paged"),
            ("flash_decode_int8", "decode_int8", 84, ("contiguous", "int8"),
             "mode_int8"),
            ("flash_decode_fp8", "decode_fp8", 84, ("contiguous", "fp8"),
             "mode_fp8")):
        row = paged_kernels[case]
        entries.append({
            "name": name, "route": "cuda", "source": src + "flash_decode.cu",
            "replaces": ref + f"flash_decode.py:{line}",
            "launches": kv_runs[run]["launches"][key],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    for name, key, line, err in (
            ("flash_attention_fwd", "fwd", 342, "out"),
            ("flash_attention_bwd_dkv", "dkv", 475, "dk"),
            ("flash_attention_bwd_dq", "dq", 711, "dq")):
        e = tr["max_abs_err"][err] if key != "dkv" else max(
            tr["max_abs_err"]["dk"], tr["max_abs_err"]["dv"])
        entries.append({
            "name": name, "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": ref + f"flash_attention.py:{line}",
            "launches": fa_launches[name], "max_abs_err": e,
            "ms": tr[f"{key}_ms"], "plain_ms": tr[f"{key}_plain_ms"],
            "bound_ms": tr["bounds"][key]["bound_ms"],
            "bound_by": tr["bounds"][key]["bound_by"],
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": tr["fwd_library_ms" if key == "fwd"
                             else "bwd_library_ms"],
            "shape": tr["shape"]})
    entries.append({
        "name": "fused_ce_fwd", "route": "cuda",
        "source": src + "fused_ce.cu", "replaces": ref + "fused_ce.py:55",
        "launches": ce_launches, "max_abs_err": ce["max_abs_err"],
        "ms": ce["ms"], "plain_ms": ce["plain_ms"],
        "bound_ms": ce["bound_ms"], "bound_by": ce["bound_by"],
        "library_ms": ce["library_ms"], "shape": ce["shape"]})
    # the fused layer stack: launches from the full-width run of the
    # kv_dtype that serves each storage mode, time and bound at pos 512
    for name, kd in (("fused_decode_layers", "bf16"),
                     ("fused_decode_layers_int8", "int8"),
                     ("fused_decode_layers_fp8", "fp8")):
        row = fused_kernels[kd]
        t = row["timed"]["512"]
        entries.append({
            "name": name, "route": "cuda", "source": src + "fused_decode.cu",
            "replaces": ref + "fused_decode.py:84",
            "launches": fused_runs[("fused", kd)]["launches"]["fused_decode"],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": row["plain_ms_at_512"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # no single library call computes a layer stack
            "library_ms": None,
            "per_op_int8_step_ms": b1_steps[kd]["per_op_int8_step_ms"],
            "shape": row["shape"] + ", pos 512"})
    # the LLaMA path's shapes of the two attention kernels, launches from
    # the llama_7b runs (flash_decode: the slot loop's decode steps and
    # prefill_into_slots calls together)
    def at_llama(launches, *names):
        return {"launches": launches, "cases": [
            {k: llama_kernels[n][k] for k in (
                "name", "shape", "max_abs_err", "limit_share", "kernel_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for n in names]}

    for e in entries:
        if e["name"] == "flash_decode":
            e["llama_7b"] = at_llama(llama_loop["launches"]["flash_decode"],
                                     "llama_decode",
                                     "llama_prefill_into_slots")
        elif e["name"] == "flash_attention_fwd":
            e["llama_7b"] = at_llama(
                llama_gen["launches"]["flash_attention_fwd"], "llama_prefill")
        if e["name"].startswith("flash_attention_"):
            # the same kernels on the llama_7b training run (4 steps)
            e["llama_7b_train_launches"] = \
                llama_train["launches_4_steps"][e["name"]]
    # RMSNorm: one kernel, one entry per policy, timed at the prefill
    # rows of llama_7b (4 x 512, bf16) with the decode rows (8) beside;
    # launches from the llama_7b runs (generate and the slot loop)
    for name, policy, replaces, note in (
            ("rms_norm", "fused", ref + "fused_norm_rope.py:33",
             "no path of the JAX package calls rms_norm_pallas, so the "
             "LLaMA runs launch this policy no time; the same kernel "
             "carries the path under policy llama"),
            ("rms_norm_llama", "llama", "paddle_tpu/models/llama.py:117",
             "an XLA function in the JAX package, not a Pallas kernel: "
             "every RMSNorm of the LLaMA path")):
        row = rms_kernels[(policy, 2048, 4096, "bfloat16")]
        dec = rms_kernels[(policy, 8, 4096, "bfloat16")]
        entries.append({
            "name": name, "route": "cuda", "source": src + "rms_norm.cu",
            "replaces": replaces, "note": note,
            "launches": (llama_gen["launches"][f"rms_{policy}"]
                         + llama_loop["launches"][f"rms_{policy}"]),
            "max_abs_err": max(r["max_abs_err"] for (p, *_), r in
                               rms_kernels.items() if p == policy),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "decode_shape": {k: dec[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms")}})
    entries[-1]["llama_7b_train_launches"] = \
        llama_train["launches_4_steps"]["rms_llama"]
    # the ring variant (a run-time offset): launches from the sequence-
    # parallel loss and gradients at the training config (a one-rank
    # ring: offset 0 each layer, [4, 2048, 32x128] bf16); times, bound
    # and SDPA with the offset's mask at that shape and offset, the ring
    # chunk of llama_7b ([1, 1024]) at every offset beside
    def ring_cell(r, key, err):
        lib = "fwd_library_ms" if key == "fwd" else "bwd_library_ms"
        return {"max_abs_err": max(r["max_abs_err"][x] for x in err),
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r["bounds"][key]["bound_ms"],
                "bound_by": r["bounds"][key]["bound_by"],
                # SDPA with the boolean mask; its backward computes dq,
                # dk and dv in one call
                "library_ms": r[lib]}

    at_train = ring_kernels[("train bfloat16", 0)]
    for kernel, key, line, err in (("fwd", "fwd", 342, ("out",)),
                                   ("bwd_dkv", "dkv", 475, ("dk", "dv")),
                                   ("bwd_dq", "dq", 711, ("dq",))):
        name = f"{RING}_{kernel}"
        entries.append({
            "name": name, "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": ref + f"flash_attention.py:{line} (traced_offset, "
                              f"via flash_attention_with_lse :1023)",
            "launches": llama_sp["offset_launches"][name],
            **ring_cell(at_train, key, err),
            "shape": at_train["shape"] + ", offset 0",
            "offsets": [{"shape": r["shape"], "offset": off,
                         **ring_cell(r, key, err)}
                        for (_, off), r in ring_kernels.items()],
            "ring_replay_launches": ring_replays["bfloat16"]["launches"][
                name]})
        # the zero-offset entry launches the same kernel with the same
        # arguments at the training run's shape (bit for bit, above)
        zero = next(e for e in entries
                    if e["name"] == f"flash_attention_{kernel}")
        zero["llama_7b_train"] = {
            "shape": at_train["shape"],
            "timed_under": f"{RING} at offset 0",
            **ring_cell(at_train, key, err)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": kernels,
             "paged_kernels": paged_kernels,
             "serving_kv": {f"{a} {b}": r for (a, b), r in kv_runs.items()},
             "train_kernels": train_kernels,
             "rounding_witness": rounding, "serving": serving,
             "fused_kernels": fused_kernels,
             "serving_b1": {f"{a} {b}": r for (a, b), r in fused_runs.items()},
             "b1_steps": b1_steps,
             "training": training, "plain_training": plain_training,
             "rms_kernels": {" ".join(map(str, k)): r
                             for k, r in rms_kernels.items()},
             "llama_kernels": llama_kernels,
             "llama_generate": llama_gen, "llama_slot_loop": llama_loop,
             "ring_kernels": {f"{a} {b}": r
                              for (a, b), r in ring_kernels.items()},
             "ring_replay": ring_replays, "llama_training": llama_train,
             "llama_sp": llama_sp},
            indent=1))
    _log({"kernels": entries})
    _log({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
