#!/usr/bin/env python3
"""The fused b1 layer stack of two checkouts on one card, in turns.

    python3 chip_fused_ab.py --root P=<parent checkout> --root C=. \\
        --order P,C,C,P --out results/fused_ab.json

Every run is a fresh process that imports the named checkout's
``paddle_tpu_torch`` and ``chip_smoke.py`` and runs that checkout's
``fused_kernel_phase`` (``fused_decode_layers`` against its plain
version in four storage modes, its time at pos 64, 512 and 1023 beside
its bound) and ``fused_serving_phase`` (``FusedB1Engine`` and the per-op
int8 engine at gpt3_1p3b with bf16 / int8 / fp8 caches: decode-loop
tok/s, one profiled step of each), on the seed-0 gpt3_1p3b weights
quantized to int8.  Every checkout's libraries are built first, all at
once, and the SASS of its ``fused_decode_kernel`` instances
(``cuobjdump -sass``) is searched for int-to-float conversions (I2F*).
The console gets one summary line a run (the phases' own rows go to
``<out>.<run>.log``); ``--out`` keeps everything.  Exits 2 without a
card.

Variants of one checkout's kernel: ``--flags LABEL=-DNAME,...`` builds
that label's fused_decode.cu with the extra nvcc flags into its own
library, which the run loads in place of the default one;
``--kernel-only`` skips the serving phase.  A label whose flags hold
``-DFD_PROFILE`` runs the phase profile instead of the phases: one
launch a storage mode (bf16, int8, fp8) and position (64, 512, 1023) at
gpt3_1p3b, and block 0's clock at each grid barrier (the kernel's
FD_PROFILE stamps) split into the work of each phase of a layer and the
wait at its barrier, in microseconds summed over the layers, beside the
phase's critical path (from block 0 leaving the last barrier to the
latest block reaching this one) and the blocks most often latest; and
inside each GEMV, block 0's time waiting for weight stages, computing,
refilling them, finishing column tiles (and three parts of that), and
making the GEMV's input before it (its SM cycles over its clock rate in
the launch).
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path


PHASES = ("qkv", "scores", "pv", "proj", "fc1", "fc2")
GEMV_PARTS = ("wait", "compute", "refill", "finish", "finish_sums",
              "finish_part", "finish_count", "input")


def _profile(cs, fdl, kvq, cfg, qparams) -> dict:
    """{mode: {pos: {phase: [work us, wait us], "total_us": ...}}} from
    the FD_PROFILE stamps of one launch (after a warm one)."""
    import torch
    L, H, nH, T = (cfg.num_layers, cfg.hidden_size, cfg.num_heads, 1024)
    out = {}
    for mode in ("bf16", "int8", "fp8"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        x = torch.randn((2, L, T, nH, H // nH), generator=gen, device="cuda")
        ck, cv, sc = cs._fused_store(kvq, x, mode)
        del x
        h0 = torch.zeros((8, H), device="cuda")
        h0[0] = torch.randn((H,), generator=gen, device="cuda")
        out[mode] = {}
        for pos in (64, 512, 1023):
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            for _ in range(2):
                h = fdl.fused_decode_layers(h0, qparams["layers"], ck, cv, p,
                                            nH, scales=sc)[0]
            torch.cuda.synchronize()
            t = h[1:].contiguous().view(torch.int64).flatten().tolist()
            n = 6 * L - 1
            # per phase: block 0's work and wait, the critical path (the
            # latest arrival), the barrier's own time after it
            row = {ph: [0.0, 0.0, 0.0, 0.0] for ph in PHASES}
            latest = {ph: Counter() for ph in PHASES}
            for b in range(n + 1):     # phase b ends at barrier b (or end)
                ph = PHASES[b % 6]
                start = t[0] if b == 0 else t[3 * b - 1]
                row[ph][0] += (t[3 * b + 1] - start) / 1e3
                if b < n:
                    last = t[3 * b + 3] & ~0xff
                    row[ph][1] += (t[3 * b + 2] - t[3 * b + 1]) / 1e3
                    row[ph][2] += (last - start) / 1e3
                    row[ph][3] += (t[3 * b + 2] - last) / 1e3
                    latest[ph][t[3 * b + 3] & 0xff] += 1
            row["columns"] = ["block 0 work", "block 0 wait",
                              "latest arrival", "barrier after it"]
            row["latest_blocks"] = {ph: c.most_common(4)
                                    for ph, c in latest.items()}
            row["total_us"] = (t[3 * n + 1] - t[0]) / 1e3
            cyc = t[3 * n + 2:3 * n + 36]
            ghz = (cyc[33] - cyc[32]) / (t[3 * n + 1] - t[0])
            row["gemv_us"] = {
                g: dict(zip(GEMV_PARTS, (c / ghz / 1e3
                                         for c in cyc[8 * i:8 * i + 8])))
                for i, g in enumerate(("qkv", "proj", "fc1", "fc2"))}
            row["sm_ghz"] = ghz
            out[mode][str(pos)] = row
        del ck, cv, sc
        torch.cuda.empty_cache()
    return out


def _child(root: Path, out: Path, lib: str, kernel_only: bool,
           profile: bool) -> None:
    """One run: this checkout's fused phases, rows into ``out``."""
    import torch
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.incubate.nn.kernels import _build
    if lib:
        _build._LOADED["fused_decode"] = ctypes.CDLL(lib)
    from paddle_tpu_torch.incubate.nn import kv_quant as kvq
    from paddle_tpu_torch.incubate.nn.kernels import flash_decode as fd
    from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine)
    from paddle_tpu_torch.models import gpt
    if not Path(fdl.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {fdl.__file__}, not {root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    qparams = gpt.quantize_decode_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    if profile:
        out.write_text(json.dumps({"profile": _profile(cs, fdl, kvq, cfg,
                                                       qparams)}))
        return
    t0 = time.perf_counter()
    kernels = cs.fused_kernel_phase(fdl, kvq, gpt, cfg, qparams)
    t1 = time.perf_counter()
    runs, steps = ({}, {}) if kernel_only else cs.fused_serving_phase(
        gpt, ContinuousBatchingEngine, FusedB1Engine, fd, fdl, cfg, qparams)
    out.write_text(json.dumps({
        "fused_kernels": kernels,
        "serving_b1": {f"{a} {b}": r for (a, b), r in runs.items()},
        "b1_steps": steps,
        "seconds": {"fused_kernel": t1 - t0,
                    "fused_serving": time.perf_counter() - t1}}))


def _sass_conversions(lib: Path) -> dict:
    """{fused_decode_kernel instance: {I2F* opcode: count}} in the
    library's SASS."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "fused_decode_kernel" in m.group(1) else None
            if name:
                out[name] = Counter()
        elif name:
            for op in re.findall(r"\b(I2F[A-Z0-9_.]*)", line):
                out[name][op] += 1
    return {k: dict(v) for k, v in out.items()}


def _build_all(roots: dict, flags: dict) -> dict:
    """Build fused_decode.cu and flash_decode.cu of every checkout, and
    each label's fused_decode.cu with its extra flags, all nvcc
    processes at once; {label: (seconds, fused_decode library)}."""
    code = ("import sys, time, json; sys.path.insert(0, sys.argv[1]); "
            "from paddle_tpu_torch.incubate.nn.kernels import _build; "
            "t = time.perf_counter(); "
            "libs = _build.build(['fused_decode', 'flash_decode']); "
            "print(json.dumps([time.perf_counter() - t, "
            "str(libs['fused_decode'])]))")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paddle_tpu_torch.incubate.nn.kernels import _build
    t0 = time.perf_counter()
    procs, variants = {}, {}
    for root in sorted(set(roots.values())):
        procs[root] = subprocess.Popen(
            [sys.executable, "-c", code, str(root)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for label, extra in flags.items():
        lib = roots[label] / "paddle_tpu_torch" / "_build" / \
            f"libfused_decode_{label}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        variants[label] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib),
             str(roots[label] / "paddle_tpu_torch" / "incubate" / "nn"
                 / "kernels" / "csrc" / "fused_decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    done = {}
    for root, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of {root}: {err}")
        done[root] = json.loads(out.strip().splitlines()[-1])
    built = {label: done[root] for label, root in roots.items()}
    for label, (proc, lib) in variants.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of {label} {flags[label]}: {log}")
        built[label] = [time.perf_counter() - t0, str(lib)]
    return built


def _summary(label: str, res: dict) -> dict:
    """The numbers a comparison reads, from one run's rows."""
    if "profile" in res:
        return {"run": label, "profile": res["profile"]}
    k, s, b1 = res["fused_kernels"], res["b1_steps"], res["serving_b1"]
    row = {"run": label}
    for mode in ("bf16", "int8", "fp8"):
        t = k[mode]["timed"]
        row[mode] = {
            "ms": {pos: t[pos]["ms"] for pos in t},
            "bound_ms_512": t["512"]["bound_ms"],
            "barriers": k[mode].get("barriers_per_token"),
            "h_share": k[mode]["h_share"],
            "row_share": k[mode]["row_share"]}
        if s:
            row[mode].update(
                decode_loop_tok_s=b1[f"fused {mode}"]["decode_loop_tok_s"],
                step_wall_ms=s[mode]["fused"]["wall_ms"],
                step_device_ms=s[mode]["fused"]["device_busy_ms"],
                idle_share=s[mode]["fused"]["idle_share"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="LABEL=checkout directory (repeat)")
    ap.add_argument("--order", required=True,
                    help="comma-separated labels, the runs in turn")
    ap.add_argument("--out", required=True, help="JSON of every result")
    ap.add_argument("--flags", action="append", default=[],
                    help="LABEL=extra nvcc flags of its fused_decode.cu, "
                         "comma-separated (repeat)")
    ap.add_argument("--kernel-only", action="store_true",
                    help="skip the serving phase")
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        lib, _, profile = args.child[2].partition(" ")
        _child(Path(args.child[0]), Path(args.child[1]), lib,
               args.kernel_only, profile == "-DFD_PROFILE")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_fused_ab: no CUDA device", file=sys.stderr)
        return 2
    roots = dict(r.split("=", 1) for r in args.root)
    roots = {k: Path(v).resolve() for k, v in roots.items()}
    flags = {k: v.split(",") for k, v in (f.split("=", 1)
                                          for f in args.flags)}
    order = args.order.split(",")
    if not set(order) <= set(roots):
        raise SystemExit(f"--order names {order}, --root gives {list(roots)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    built = _build_all(roots, flags)
    result = {"card": card, "order": order, "roots": {
        k: str(v) for k, v in roots.items()}, "build": {}, "runs": []}
    for label, (secs, lib) in built.items():
        result["build"][label] = {"seconds": secs, "library": lib,
                                  "sass_i2f": _sass_conversions(Path(lib))}
        print(json.dumps({"build": label, **result["build"][label]}),
              flush=True)
    for i, label in enumerate(order):
        rows = out.with_suffix(f".{i}{label}.json")
        log = out.with_suffix(f".{i}{label}.log")
        t0 = time.perf_counter()
        lib = built[label][1] if label in flags else ""
        profile = "-DFD_PROFILE" in flags.get(label, ())
        with open(log, "w") as fh:
            proc = subprocess.run(
                [sys.executable, __file__, "--root", "x=.", "--order", "x",
                 "--out", str(out), "--child", str(roots[label]), str(rows),
                 lib + (" -DFD_PROFILE" if profile else "")]
                + (["--kernel-only"] if args.kernel_only else []),
                stdout=fh, stderr=subprocess.STDOUT)
        if proc.returncode:
            print(log.read_text()[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} ({label}) failed")
        res = json.loads(rows.read_text())
        res["label"], res["wall_s"] = label, time.perf_counter() - t0
        result["runs"].append(res)
        print(json.dumps(_summary(f"{label}{i}", res)), flush=True)
        out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
