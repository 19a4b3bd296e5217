#!/usr/bin/env python3
"""The flash forward's host cost a call, serving prefill and the training
step of several checkouts on one card, in turns.

    python3 tools/flash_op_ab.py --root P=<parent checkout> --root C=. \\
        --order P,C,C,P --out flash_op_ab.json

Every run is a fresh process that imports the named checkout's
``paddle_tpu_torch`` (``chip_smoke.py`` beside this tool only builds the
serving engine and its prompts through the entry points) and measures:

* the host time of one ``flash_attention`` call (the entry point that
  serving prefill and the models' forward take): bf16 [1, 128, 16, 128],
  causal, 500 calls queued back to back after 50 warm ones, the host
  clock around the loop before the sync (the launch queue is not full,
  so the host never waits for the card), and the card's time a call by
  CUDA events around the same loop: once under ``torch.inference_mode``
  (serving) and once with q, k and v requiring grad (the training
  forward, which also records the graph);
* prefill: gpt3_1p3b at full width (bf16, seed-0 weights), the
  contiguous bf16 engine of ``chip_smoke.graph_case_engine`` over the
  12 seeded prompts of ``chip_smoke.graph_prompts`` (32-700 tokens)
  with one new token each, so a run is prefill and one decode round:
  two warm runs, then ``--reps`` timed runs (wall, synced) whose
  streams must equal the first run's;
* training: gpt3_1p3b, 24 layers, B 8, S 1024, remat False,
  ``hybrid.build_train_step``: two warm steps, then 4 steps each with
  the host clock around the step call (its dispatch; the step does not
  sync) and CUDA events around it, and the losses.

Every checkout's flash library is built first, all at once.  The console
gets one summary line a run; ``--out`` keeps every run and the medians
by label.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = ["flash_attention", "flash_decode", "row_gemm", "sampling"]
OP_SHAPE = (1, 128, 16, 128)
OP_CALLS, OP_WARM = 500, 50
TRAIN_STEPS = 4


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


def _op_cost(torch, fa, grad: bool) -> dict:
    """Host and card microseconds a ``flash_attention`` call."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(OP_SHAPE, device="cuda", dtype=torch.bfloat16,
                           generator=g).requires_grad_(grad)
               for _ in range(3))

    def calls(n):
        for _ in range(n):
            fa.flash_attention(q, k, v, causal=True)

    if grad:
        calls(OP_WARM)
    else:
        with torch.inference_mode():
            calls(OP_WARM)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    if grad:
        calls(OP_CALLS)
    else:
        with torch.inference_mode():
            calls(OP_CALLS)
    host = time.perf_counter() - t0
    b.record()
    torch.cuda.synchronize()
    return {"host_us": host / OP_CALLS * 1e6,
            "card_us": a.elapsed_time(b) / OP_CALLS * 1e3}


def _run(root: Path, reps: int) -> dict:
    import numpy as np
    import torch
    cs = _import_root(root)
    from paddle_tpu_torch.distributed import hybrid
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine,
        PagedContinuousBatchingEngine)
    from paddle_tpu_torch.models import gpt
    out = {"card": cs._nvidia_smi("name,power.limit"),
           "op_inference": _op_cost(torch, fa, False),
           "op_grad": _op_cost(torch, fa, True)}
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    case = next(c for c in cs.GRAPH_CASES if c[0] == "contiguous bf16")
    eng, prompts = cs.graph_case_engine(
        (ContinuousBatchingEngine, PagedContinuousBatchingEngine,
         FusedB1Engine), case, cfg, params, None)

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=1, seed=i + 1)
                for i, p in enumerate(prompts)]
        res = eng.run()
        torch.cuda.synchronize()
        return ([list(map(int, res[r])) for r in rids],
                (time.perf_counter() - t0) * 1e3)

    for _ in range(2):
        streams = serve()[0]
    walls = []
    for _ in range(reps):
        got, wall = serve()
        if got != streams:
            raise AssertionError("prefill: streams moved between runs")
        walls.append(wall)
    out["prefill"] = {"prompts": len(prompts),
                      "tokens": int(sum(len(p) for p in prompts)),
                      "wall_ms": walls, "streams": streams}
    del eng
    torch.cuda.empty_cache()
    step, shard, init_opt = hybrid.build_train_step(cfg, remat=False,
                                                    device="cuda")
    p = shard(params)
    del params
    o = init_opt(p)
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 1024)),
                       device="cuda")
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 1024)),
                          device="cuda")
    losses = [step(p, o, ids, labels)[0].item() for _ in range(2)]
    host, card = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        loss = step(p, o, ids, labels)[0]
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        torch.cuda.synchronize()
        card.append(a.elapsed_time(b))
        losses.append(loss.item())
    out["train"] = {"host_ms": host, "card_ms": card, "losses": losses}
    return out


def _summary(label, r) -> str:
    return (f"{label}: op host us inference "
            f"{r['op_inference']['host_us']:.2f} grad "
            f"{r['op_grad']['host_us']:.2f}; prefill ms "
            f"{statistics.median(r['prefill']['wall_ms']):.2f}; train host "
            f"ms {statistics.median(r['train']['host_ms']):.2f} card ms "
            f"{statistics.median(r['train']['card_ms']):.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="LABEL=checkout directory")
    ap.add_argument("--order", help="labels in run order (default: each "
                    "root once, in the order given)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed prefill runs a run")
    ap.add_argument("--out", help="write every run and the medians here")
    ap.add_argument("--worker", choices=("build", "run"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    roots = dict(r.split("=", 1) for r in args.root)
    roots = {k: Path(v).resolve() for k, v in roots.items()}
    if args.worker:
        (label, root), = roots.items()
        if args.worker == "build":
            _build(root)
        else:
            print(json.dumps(_run(root, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_op_ab: no CUDA device", file=sys.stderr)
        return 2
    me = [sys.executable, str(Path(__file__).resolve())]
    builds = [subprocess.Popen(me + ["--worker", "build", "--root",
                                     f"{k}={v}"]) for k, v in roots.items()]
    if any(b.wait() != 0 for b in builds):
        print("flash_op_ab: a build failed", file=sys.stderr)
        return 1
    order = args.order.split(",") if args.order else list(roots)
    runs = []
    for label in order:
        proc = subprocess.run(
            me + ["--worker", "run", "--reps", str(args.reps), "--root",
                  f"{label}={roots[label]}"],
            capture_output=True, text=True, env=dict(os.environ))
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(_summary(label, r), flush=True)
    first = runs[0]
    for r in runs[1:]:
        if r["prefill"]["streams"] != first["prefill"]["streams"]:
            print(f"flash_op_ab: {r['label']}'s prefill streams differ from "
                  f"{first['label']}'s", file=sys.stderr)
            return 1
    medians = {}
    for label in dict.fromkeys(order):
        rs = [r for r in runs if r["label"] == label]
        medians[label] = {
            "op_inference_host_us": statistics.median(
                r["op_inference"]["host_us"] for r in rs),
            "op_grad_host_us": statistics.median(
                r["op_grad"]["host_us"] for r in rs),
            "prefill_ms": statistics.median(
                w for r in rs for w in r["prefill"]["wall_ms"]),
            "train_host_ms": statistics.median(
                h for r in rs for h in r["train"]["host_ms"]),
            "train_card_ms": statistics.median(
                c for r in rs for c in r["train"]["card_ms"])}
    print(json.dumps({"medians": medians, "card": first["card"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "medians": medians}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
