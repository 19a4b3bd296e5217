#!/usr/bin/env python3
"""LLaMA's decode step, its training step and its RMS kernels, of several
checkouts on one card, in turns.

    python3 tools/llama_ab.py --root P=<parent checkout> --root C=. \\
        --order P,C,C,P --out chiprun_out/llama_ab.json

Every run is a fresh process that imports the named checkout's
``paddle_tpu_torch`` (the harness, ``chip_smoke.py`` beside this tool,
only drives it through the model's entry points) and measures:

* the RMS forward: ``rms_norm`` of the checkout in both policies,
  bfloat16 and float32, at ``chip_smoke.RMS_CASES`` and the training
  rows ``RMS_TRAIN_ROWS`` (``chip_smoke._time_ms`` with L2 flushed, as
  ``rms_kernel_phase`` times it), with a digest of each output's bits,
  so that two checkouts' kernels can be told bit for bit equal or not;
* serving: llama_7b at full width (bf16, seed-0 weights), the runs of
  ``chip_smoke.llama_serving_phase`` — ``generate`` of 4 seeded 512-token
  prompts and the slot loop (``chip_smoke.llama_slot_loop``) over its 8
  seeded prompts (max_len 1024, attn_kernel "flash"), 32 greedy tokens
  each, whose streams are held against the first label's first run
  (``generate``'s greedy loop is also written out to record each step's
  gap between the two largest logits of each row, so that a stream that
  parts can be told a near-tie or not) — then the slot loop's last
  decode step under the profiler (``chip_smoke.norm_add_profile``:
  device ms and kernels a step, the RMS kernels' ms and launches, the
  separate residual adds' ms and count) and under CUDA events (the
  median of 20 steps);
* training: llama_7b's width at 8 layers, B 4, S 2048, one seeded batch,
  ``build_train_step(model=llama_stage_model(cfg, remat))``: without
  remat two warm steps, then 4 steps under CUDA events (ms a step) and
  their peak memory, and one step under the profiler by family (flash
  forward and backward, RMS kernels, GEMMs, the rest); then with remat
  one warm step and 2 under CUDA events, and their peak memory.

Every checkout's kernel libraries are built first, all at once.  The
console gets one summary line a run; ``--out`` keeps every run and the
medians by label.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = ["rms_norm", "flash_decode", "flash_attention"]
FAMILIES = (("flash_fwd", ("flash_attention_fwd",)),
            ("flash_bwd", ("flash_attention_bwd",)),
            ("rms", ("rms_norm",)))


def _import_root(root: Path):
    """The checkout's package first on the path; this tool's chip_smoke
    (its helpers take the modules they drive as arguments)."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    if Path(paddle_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {paddle_tpu_torch.__file__}, not the "
                           f"checkout {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _build(root: Path) -> None:
    _import_root(root)
    from paddle_tpu_torch.incubate.nn.kernels import _build as b
    b.build(SOURCES)


def _events_ms(torch, fn, n):
    """Median device ms of ``fn`` over n runs, each bracketed by CUDA
    events after a synchronise."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _generate_gaps(torch, llama, params, ids, cfg, new):
    """``llama.generate``'s greedy path written out (``prefill``, then
    ``decode_step`` at host positions): (tokens [B][new], the gap
    between each row's two largest float32 logits at each step)."""
    B, S = ids.shape
    cache = llama.init_decode_cache(cfg, B, S + new, device="cuda")
    tables = llama._tables(params, cfg, None)
    toks, gaps = [], []
    with torch.inference_mode():
        logits, cache, pos = llama.prefill(params, ids, cfg, cache)
        for i in range(new):
            top = logits.float().topk(2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).tolist())
            tok = logits.argmax(-1)
            toks.append(tok.tolist())
            if i + 1 < new:
                logits, cache = llama.decode_step(params, cache, tok,
                                                  pos + i, cfg, tables)
    return [list(r) for r in zip(*toks)], [list(r) for r in zip(*gaps)]


def _first_parting(runs, labels):
    """Where the first two labels' generate streams part: (row, step)
    and each label's gap there, or None."""
    a, b = (next(r for r in runs if r["label"] == lb) for lb in labels[:2])
    for row, (x, y) in enumerate(zip(a["generate_streams"],
                                     b["generate_streams"])):
        step = next((i for i, (s, t) in enumerate(zip(x, y)) if s != t),
                    None)
        if step is not None:
            return {"row": row, "step": step,
                    "gap": {r["label"]: r["generate_gaps"][row][step]
                            for r in (a, b)}}
    return None


def _rms_forward(cs, torch, fnr) -> dict:
    """{"policy dtype NxH": {"ms", "sha1"}} of the checkout's forward."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    res = {}
    for N, H in cs.RMS_CASES + (cs.RMS_TRAIN_ROWS,):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((N, H), generator=gen, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn((H,), generator=gen,
                                       device="cuda")).to(dt)
            for policy in ("fused", "llama"):
                out = fnr.rms_norm(x, w, 1e-6, policy)[0]
                bits = out.view(torch.int16 if dt == torch.bfloat16
                                else torch.int32).cpu().numpy().tobytes()
                res[f"{policy} {str(dt).split('.')[-1]} {N}x{H}"] = {
                    "ms": cs._time_ms(lambda: fnr.rms_norm(x, w, 1e-6,
                                                           policy),
                                      flush=flush),
                    "sha1": hashlib.sha1(bits).hexdigest()}
    del flush
    torch.cuda.empty_cache()
    return res


def _train_ms(torch, step, n):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        loss = step()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, torch.cuda.max_memory_allocated(), loss


def _run(root: Path) -> dict:
    cs = _import_root(root)
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import hybrid
    from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope as fnr
    from paddle_tpu_torch.models import llama
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": cs._nvidia_smi("name,power.limit"),
           "rms_forward": _rms_forward(cs, torch, fnr)}
    # serving: the slot loop's last decode step
    cfg = llama.llama_7b(dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 512)),
                       device="cuda")
    out["generate_streams"] = llama.generate(
        params, ids, cfg, max_new_tokens=32).cpu().tolist()
    toks, out["generate_gaps"] = _generate_gaps(torch, llama, params, ids,
                                                cfg, 32)
    out["generate_loop_equals_generate"] = toks == out["generate_streams"]
    rng = np.random.default_rng(0)
    lens = cs._llama_prompt_lens(rng)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    loop = cs.llama_slot_loop(llama, params, cfg, prompts, 32, 1024,
                              attn_kernel="flash")
    cache, tok, pos = loop["cache"], loop["token"], loop["pos"]

    def step():
        with torch.inference_mode():
            llama.decode_step_multi(params, cache, tok, pos, cfg,
                                    attn_kernel="flash")

    out["decode_step"] = cs.norm_add_profile(step, len(prompts),
                                             cfg.hidden_size, n=20)
    out["decode_step"]["events_ms"] = _events_ms(torch, step, 20)
    out["streams"] = loop["streams"]
    del params, cache, loop
    torch.cuda.empty_cache()
    # training: 8 layers, B 4, S 2048
    cfg = llama.llama_7b(num_layers=cs.LLAMA_TRAIN_LAYERS,
                         dtype=torch.bfloat16)
    train, shard, init_opt = hybrid.build_train_step(
        cfg, device="cuda", model=hybrid.llama_stage_model(cfg, remat=False))
    params = shard(llama.init_params(cfg, seed=0, device="cuda"))
    ids, labels = cs._train_batch(cfg, cs.LLAMA_TRAIN_B, cs.LLAMA_TRAIN_S)
    opt = init_opt(params)
    losses = []
    for _ in range(2):
        losses.append(train(params, opt, ids, labels)[0].item())
    out["train_step_ms"], out["train_peak_bytes"], loss = _train_ms(
        torch, lambda: train(params, opt, ids, labels)[0], 4)
    losses.append(loss.item())
    out["train_losses"] = losses
    prof = cs._profile(lambda: train(params, opt, ids, labels), 1,
                       out["train_step_ms"], list(FAMILIES))
    out["train_profile"] = {k: prof[k] for k in (
        "device_ms", "device_busy_ms", "kernels_per_step", "idle_share")}
    remat, _, _ = hybrid.build_train_step(
        cfg, device="cuda", model=hybrid.llama_stage_model(cfg, remat=True))
    remat(params, opt, ids, labels)
    out["remat_step_ms"], out["remat_peak_bytes"], loss = _train_ms(
        torch, lambda: remat(params, opt, ids, labels)[0], 2)
    out["remat_loss"] = loss.item()
    return out


def _summary(label, r) -> str:
    d = r["decode_step"]
    line = (f"{label}: decode step {d['device_ms']:.4f} ms device "
            f"({d['events_ms']:.4f} events), {d['kernels']:.1f} kernels, "
            f"norm {d['rms_ms']:.4f} ms in {d['rms_launches']:.0f}, "
            f"residual adds {d['residual_add_ms']:.4f} ms in "
            f"{d['residual_adds']:.0f}")
    return line + (f"; train step {r['train_step_ms']:.2f} ms, rms "
                   f"{r['train_profile']['device_ms']['rms']:.3f}, other "
                   f"{r['train_profile']['device_ms']['other']:.2f}, peak "
                   f"{r['train_peak_bytes'] / 1e9:.2f} GB; remat step "
                   f"{r['remat_step_ms']:.2f} ms, peak "
                   f"{r['remat_peak_bytes'] / 1e9:.2f} GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="LABEL=PATH of a checkout (repeat)")
    ap.add_argument("--order", help="labels in run order (default: each "
                    "once)")
    ap.add_argument("--out", help="write every run and the medians here")
    ap.add_argument("--worker", choices=("build", "run"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    roots = {}
    for item in args.root:
        label, _, path = item.partition("=")
        roots[label] = Path(path).resolve()
    if args.worker:
        (root,) = roots.values()
        if args.worker == "build":
            _build(root)
        else:
            print(json.dumps(_run(root)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("llama_ab: no CUDA device", file=sys.stderr)
        return 2
    me = [sys.executable, str(Path(__file__).resolve())]
    procs = [subprocess.Popen(me + ["--worker", "build", "--root",
                                    f"{k}={v}"]) for k, v in roots.items()]
    if any(p.wait() for p in procs):
        print("llama_ab: a build failed", file=sys.stderr)
        return 1
    order = args.order.split(",") if args.order else list(roots)
    runs = []
    for label in order:
        cmd = me + ["--worker", "run", "--root", f"{label}={roots[label]}"]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             env={**os.environ, "PYTHONUNBUFFERED": "1"})
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(_summary(label, r), flush=True)
    medians = {}
    for label in roots:
        mine = [r for r in runs if r["label"] == label]
        med = {k: statistics.median(r["decode_step"][k] for r in mine)
               for k in mine[0]["decode_step"]}
        for key in ("train_step_ms", "train_peak_bytes", "remat_step_ms",
                    "remat_peak_bytes"):
            med[key] = statistics.median(r[key] for r in mine)
        med["rms_forward_ms"] = {
            case: statistics.median(r["rms_forward"][case]["ms"]
                                    for r in mine)
            for case in mine[0]["rms_forward"]}
        medians[label] = med
    print(json.dumps({"medians": medians}), flush=True)
    # each label's streams and RMS output bits against the first run's
    first = runs[0]
    same = {label: {
        "generate_streams": all(r["generate_streams"]
                                == first["generate_streams"]
                                for r in runs if r["label"] == label),
        "streams": all(r["streams"] == first["streams"]
                       for r in runs if r["label"] == label),
        "rms_forward_bits": sorted(
            case for case, v in first["rms_forward"].items()
            if all(r["rms_forward"][case]["sha1"] == v["sha1"]
                   for r in runs if r["label"] == label))}
        for label in roots}
    print(json.dumps({"equal_to_" + first["label"]: same,
                      "generate_first_parting": _first_parting(
                          runs, list(roots))}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"runs": runs, "medians": medians, "order": order}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
