#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases; any failure is an uncaught exception and a non-zero exit:

1. setup — require CUDA, print the card's name and power limit
   (nvidia-smi), build every CUDA kernel of the serving path from the
   sources in the checkout and print the build seconds.
2. kernels — hold ``flash_decode`` against its plain PyTorch version
   on the card at the serving path's shapes (bf16 against the plain
   float32 math at atol 2e-2, float32 at atol 1e-4); time the kernel,
   the plain version and ``F.scaled_dot_product_attention`` with an
   explicit boolean mask (the yardstick, never called by the port), and
   compute each shape's bound from the bytes and operations its inputs
   need.
3. reference — the engine on the card (flash kernel) against the same
   engine on the CPU (plain version), gpt_tiny in float32: identical
   greedy streams.
4. serving — gpt3_1p3b at full width (24 layers, H 2048, 16 heads of
   128, V 50304, bf16, random weights from seed 0) behind
   ``ContinuousBatchingEngine(max_batch=8, max_len=1024,
   attn_kernel="flash")``: 12 requests with seeded prompt lengths
   32-700 and max_new 32, all DONE with 32 tokens; the kernel's launch
   count, reset just before, must equal 24 per decode step plus 24 per
   prefill program.  Then one ``decode_step_multi`` at that width,
   "flash" against "xla", logits finite and within atol 0.25, and a
   profile of where a decode step's time goes.
5. the kernels line and, last, the device line.

TF32 is off for every matmul (``allow_tf32 = False``), so float32
parity is not loosened by the card's TF32 mode.
"""
from __future__ import annotations

import argparse
import json
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


def _log(obj):
    print(json.dumps(obj), flush=True)


def _time_ms(fn, reps=20, flush=None):
    """Median of per-call CUDA-event times; ``flush`` (a large buffer)
    is rewritten before each call so the inputs start cold in L2."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
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


def _work(B, W, T, nH, nKV, hD, pos, elem):
    """Bytes and operations one call needs on these inputs: q read and
    out written once, each visible K/V row read once per kv head, 4*hD
    operations per visible (query, row) pair and head."""
    rows = [min(p + W - 1, T - 1) + 1 for p in pos]
    pairs = sum(min(p + j, T - 1) + 1 for p in pos for j in range(W))
    nbytes = (2 * B * W * nH * hD + 2 * sum(rows) * nKV * hD) * elem \
        + 4 * B
    return nbytes, 4 * hD * nH * pairs


def kernel_phase(fd):
    rng = np.random.default_rng(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cases = [
        # name, B, W, T, nH, nKV, dtype, pos, packed (q/k/v sliced from qkv)
        ("decode", 8, 1, 1024, 16, 16, torch.bfloat16, "ragged", False),
        ("verify", 8, 4, 1024, 16, 16, torch.bfloat16, "ragged", False),
        ("prefill", 2, 512, 512, 16, 16, torch.bfloat16, "zero", True),
        ("prefill_1024", 2, 1024, 1024, 16, 16, torch.bfloat16, "zero",
         True),
        ("decode_gqa", 8, 1, 1024, 16, 4, torch.bfloat16, "ragged", False),
        ("decode_f32", 8, 1, 1024, 16, 16, torch.float32, "ragged", False),
    ]
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
        atol = 2e-2 if dt == torch.bfloat16 else 1e-4
        if not err <= atol:
            raise AssertionError(f"flash_decode {name}: max abs err {err} "
                                 f"> {atol}")
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
            "phase": "kernel", "name": name,
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
            "max_abs_err": err, "atol": atol,
            "library_max_abs_err": float(lib_err),
        }
        _log(row)
        results.append(row)
    return results


def reference_phase(gpt, Engine):
    """The card's flash engine against the CPU engine on gpt_tiny in
    float32: identical greedy streams."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu_params = gpt.init_params(cfg, seed=1, device="cpu")
    gpu_params = {k: ({n: w.cuda() for n, w in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
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
    return cfg, params, row, launches


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
            prof = _step_profile(gpt, cfg, params, cache, tok, pos, kernel)
            _log(dict(phase="decode_step", attn_kernel=kernel, slots=B,
                      tok_s=B / prof["wall_ms"] * 1e3, **prof))


def _step_profile(gpt, cfg, params, cache, tok, pos, kernel):
    """Wall time of one eager decode step (synchronised) against the
    device time the profiler sees in it, by kernel family."""
    def step():
        gpt.decode_step_multi(params, cache, tok, pos, cfg,
                              attn_kernel=kernel)

    for _ in range(10):
        step()
    torch.cuda.synchronize()
    n = 20
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n * 1e3)
    wall_ms = statistics.median(windows)
    clocks = _nvidia_smi("clocks.sm,power.draw")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # device kernels only; cuBLAS's Hopper GEMMs are named nvjet_*
    fam = {"flash_decode": 0.0, "matmul": 0.0, "other": 0.0}
    kernels, top = 0, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or "CUDA" not in str(getattr(ev, "device_type", "CUDA")):
            continue
        name = ev.key.lower()
        kernels += ev.count
        top.append((us / n / 1e3, ev.count // n, ev.key[:70]))
        if "flash_decode" in name:
            fam["flash_decode"] += us
        elif any(s in name for s in ("nvjet", "gemm", "cutlass", "cublas",
                                     "gemv")):
            fam["matmul"] += us
        else:
            fam["other"] += us
    dev_ms = {k: v / n / 1e3 for k, v in fam.items()}
    busy = sum(dev_ms.values())
    return {"wall_ms": wall_ms, "wall_ms_windows": windows,
            "sm_clock_power": clocks, "device_ms": dev_ms,
            "device_busy_ms": busy, "kernels_per_step": kernels / n,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "top_kernels_ms_count_name": sorted(top, reverse=True)[:8]}


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
    from paddle_tpu_torch.incubate.nn.kernels import _build
    from paddle_tpu_torch.incubate.nn.kernels import flash_decode as fd
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import gpt

    card = _nvidia_smi("name,power.limit")
    print(card, flush=True)
    _log({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})
    t0 = time.perf_counter()
    libs = _build.build(["flash_decode"])
    _log({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs.values()]})

    kernels = kernel_phase(fd)
    reference_phase(gpt, ContinuousBatchingEngine)
    cfg, params, serving, launches = serving_phase(
        gpt, ContinuousBatchingEngine, fd)
    compare_phase(gpt, cfg, params)

    dec = kernels[0]
    line = {"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "paddle_tpu_torch/incubate/nn/kernels/csrc/"
                  "flash_decode.cu",
        "replaces": "paddle_tpu/incubate/nn/kernels/flash_decode.py:67",
        "launches": launches, "max_abs_err": dec["max_abs_err"],
        "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "shape": dec["shape"]}]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": kernels, "serving": serving},
            indent=1))
    _log(line)
    _log({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
