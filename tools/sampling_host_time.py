"""Host time of one sampled and one greedy draw, for the checkout at
``--root``.

The draw is the decode step's: ``decoding.sample_token_pos`` on [8,
50304] float32 logits with the slots' int32 seeds and positions, at
temperature 0.8, top-k 20, top-p 0.95 (sampled) and at temperature 0
(greedy, ``torch.argmax``).  In each of ``--windows`` windows, queues a
device sleep long enough to hold the window, then issues ``--calls``
draws with no sync and reads the host clock: the device runs none of
them while the host issues them, so the time is the host's own (checks,
plan, allocation, launches).  Windows stay short so that a checkout
whose draw issues many launches does not fill the launch queue (about
1000 launches behind one sleep block the host).  Prints one JSON line:
the median window's host microseconds a draw of each kind.

    python3 tools/sampling_host_time.py --root .             # this tree
    python3 tools/sampling_host_time.py --root <other tree>  # e.g. a parent

Needs a CUDA card; time both checkouts on the same card, in turns, to
compare them.
"""
import argparse
import json
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--calls", type=int, default=12)
    ap.add_argument("--windows", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("sampling_host_time: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models import decoding
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((8, 50304), generator=gen, device="cuda") * 3
    seeds = torch.arange(1, 9, dtype=torch.int32, device="cuda")
    pos = torch.arange(100, 108, dtype=torch.int32, device="cuda")
    kinds = {
        "sampled": lambda: decoding.sample_token_pos(
            logits, seeds, pos, 0.8, 20, 0.95),
        "greedy": lambda: decoding.sample_token_pos(logits, seeds, pos, 0.0)}
    out = {}
    for name, draw in kinds.items():
        for _ in range(20):
            draw()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(args.windows):
            # ~2 ms of device sleep a draw: the queue never drains meanwhile
            torch.cuda._sleep(4_000_000 * args.calls)
            t = time.perf_counter()
            for _ in range(args.calls):
                draw()
            per_call.append((time.perf_counter() - t) / args.calls * 1e6)
            torch.cuda.synchronize()
        out[name] = {"host_us_per_call": statistics.median(per_call),
                     "windows_us": per_call}
    print(json.dumps({"root": args.root, "calls": args.calls,
                      "host_us": {k: v["host_us_per_call"]
                                  for k, v in out.items()},
                      "runs": out,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
