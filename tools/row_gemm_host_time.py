"""Host time of one ``row_gemm`` call, for the checkout at ``--root``.

In each of ``--windows`` windows, queues a device sleep long enough to
hold the window, then issues ``--calls`` calls of gpt3_1p3b's qkv
product at M 8 (bf16, [2048, 6144]) with no sync and reads the host
clock: the device runs none of them while the host issues them, so the
time is the wrapper's own (checks, allocation, plan, launch).  Windows
of 250 calls stay clear of the launch queue's depth (1000 calls behind
one sleep block the host on a full queue).  Prints one JSON line: the
median window's host microseconds a call.

    python3 tools/row_gemm_host_time.py --root .             # this tree
    python3 tools/row_gemm_host_time.py --root <other tree>  # e.g. a parent

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
    ap.add_argument("--calls", type=int, default=250)
    ap.add_argument("--windows", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("row_gemm_host_time: no CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 2048), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((2048, 6144), generator=gen, device="cuda")
         * 0.02).bfloat16()
    for _ in range(20):
        rg.row_gemm(x, w)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(args.windows):
        # ~100 us of device sleep a call: the queue never drains meanwhile
        torch.cuda._sleep(200_000 * args.calls)
        t = time.perf_counter()
        for _ in range(args.calls):
            rg.row_gemm(x, w)
        per_call.append((time.perf_counter() - t) / args.calls * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"root": args.root, "calls": args.calls,
                      "host_us_per_call": statistics.median(per_call),
                      "windows_us": per_call,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
