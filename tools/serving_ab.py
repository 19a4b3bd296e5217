#!/usr/bin/env python3
"""The captured serving engines' decode-loop tok/s of several checkouts on
one card, in turns.

    python3 tools/serving_ab.py --root P=<parent checkout> --root C=. \\
        --order P,C,C,P --step-timeout C=30 --out serving_ab.json

Every run is a fresh process that imports the named checkout's
``paddle_tpu_torch`` (``chip_smoke.py`` beside this tool only drives it
through the engines' entry points) and serves, on gpt3_1p3b at full
width (bf16, seed-0 weights; the fused engine its int8 serving weights),
the requests of ``chip_smoke.compiled_serving_phase`` — 12 seeded
prompts of 32-700 tokens (the fused engine the first 3), 32 greedy
tokens each — through default (captured) engines: contiguous bf16,
paged bf16 (64-token pages), n-gram k 3 on contiguous bf16 and fused b1
int8.  Each engine is warmed by two runs (every program eager once,
then captured); then ``--reps`` timed runs, each giving the decode-loop
tok/s as ``compiled_serving`` reads it (tokens over the engine's
``decode_seconds``: the host clock around each decode round, its sync
included) and the run's wall.  A label given ``--step-timeout
LABEL=SECONDS`` also serves each run once more through a second engine
of each case with that ``step_timeout`` (the watchdog thread on), in
turns with the first.  Every run's streams must equal the first run's.

Every checkout's kernel libraries are built first, all at once.  The
console gets one summary line a run; ``--out`` keeps every run and the
medians by label.  Exits 2 without a card.
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
SOURCES = ["flash_decode", "fused_decode", "row_gemm", "sampling"]
CASES = ("contiguous bf16", "paged bf16", "ngram contiguous bf16",
         "fused int8")


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


def _run(root: Path, reps: int, step_timeout) -> dict:
    import torch
    cs = _import_root(root)
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine,
        PagedContinuousBatchingEngine)
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    qparams = gpt.quantize_decode_params(params, cfg)
    timeouts = [None] + ([step_timeout] if step_timeout is not None else [])
    out = {"card": cs._nvidia_smi("name,power.limit"), "cases": {}}
    engines = (ContinuousBatchingEngine, PagedContinuousBatchingEngine,
               FusedB1Engine)
    for case in cs.GRAPH_CASES:
        label = case[0]
        if label not in CASES:
            continue

        def make(timeout):
            eng, reqs = cs.graph_case_engine(engines, case, cfg, params,
                                             qparams)
            if timeout is not None:
                eng.step_timeout = timeout
            return eng, reqs

        def serve(eng):
            base = eng.metrics()
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new=32, seed=i + 1)
                    for i, p in enumerate(reqs)]
            res = eng.run(steps_per_sync=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = eng.metrics()["decode_seconds"] - base["decode_seconds"]
            return ([list(map(int, res[r])) for r in rids],
                    32 * len(reqs) / d, 32 * len(reqs) / wall)

        engs = {}
        for t in timeouts:
            engs[t], reqs = make(t)
        for eng in engs.values():
            for _ in range(2):
                streams = serve(eng)[0]
        rows = {str(t): {"tok_s": [], "e2e_tok_s": []} for t in timeouts}
        for _ in range(reps):
            for t, eng in engs.items():
                got, tok_s, e2e = serve(eng)
                if got != streams:
                    raise AssertionError(f"{label}: streams moved between "
                                         f"runs")
                rows[str(t)]["tok_s"].append(tok_s)
                rows[str(t)]["e2e_tok_s"].append(e2e)
        out["cases"][label] = {"streams": streams, **rows}
        del engs
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="LABEL=PATH of a checkout (repeat)")
    ap.add_argument("--order", help="labels in run order (default: each "
                    "once)")
    ap.add_argument("--step-timeout", action="append", default=[],
                    help="LABEL=SECONDS: that label's runs also serve "
                    "through engines with this step_timeout")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs of each engine a process")
    ap.add_argument("--out", help="write every run and the medians here")
    ap.add_argument("--worker", choices=("build", "run"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    roots = {}
    for item in args.root:
        label, _, path = item.partition("=")
        roots[label] = Path(path).resolve()
    timeouts = {}
    for item in args.step_timeout:
        label, _, sec = item.partition("=")
        timeouts[label] = float(sec)
    if args.worker:
        (label, root), = roots.items()
        if args.worker == "build":
            _build(root)
        else:
            print(json.dumps(_run(root, args.reps, timeouts.get(label))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    me = [sys.executable, str(Path(__file__).resolve())]
    procs = [subprocess.Popen(me + ["--worker", "build", "--root",
                                    f"{k}={v}"]) for k, v in roots.items()]
    if any(p.wait() for p in procs):
        print("serving_ab: a build failed", file=sys.stderr)
        return 1
    order = args.order.split(",") if args.order else list(roots)
    runs = []
    for label in order:
        cmd = me + ["--worker", "run", "--root", f"{label}={roots[label]}",
                    "--reps", str(args.reps)]
        if label in timeouts:
            cmd += ["--step-timeout", f"{label}={timeouts[label]}"]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             env={**os.environ, "PYTHONUNBUFFERED": "1"})
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(json.dumps({"label": label, "tok_s": {
            case: {t: statistics.median(v["tok_s"]) for t, v in c.items()
                   if t != "streams"}
            for case, c in r["cases"].items()}}), flush=True)
    medians = {}
    for label in roots:
        mine = [r for r in runs if r["label"] == label]
        medians[label] = {
            case: {t: {k: statistics.median(x for r in mine
                                            for x in r["cases"][case][t][k])
                       for k in ("tok_s", "e2e_tok_s")}
                   for t in mine[0]["cases"][case] if t != "streams"}
            for case in mine[0]["cases"]}
    first = runs[0]
    same = {r["label"]: all(r["cases"][c]["streams"]
                            == first["cases"][c]["streams"]
                            for c in first["cases"]) for r in runs}
    print(json.dumps({"medians": medians, "card": first["card"],
                      "streams_equal_to_first_run": same}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"runs": runs, "medians": medians, "order": order}, indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
