"""The sampler under every cluster size, and the launch floor.

For [R, 50304] float32 logits (R 1, 8, 32 and 64: a request alone, an
8-slot decode step, its k 3 verify pass, a batch of 64) at the serving
setting (temperature 0.8, top-k 20, top-p 0.95) and at temperature
alone, times ``csrc/sampling.cu`` with each cluster size of
``sampling.CLUSTER_SIZES`` whose slice fits the shared memory, in as
many waves as the card's cluster fits make it, over rotating copies of
the logits (``chip_smoke._time_rotating``, the method of
``chip_smoke.py``'s ``sampling_kernel`` phase), and marks the one
``sampling_plan`` takes.  Also prints the card's cluster fits and the
CUDA-event time of a minimal kernel (a one-cycle ``torch.cuda._sleep``),
the floor under every time of that method.  One JSON line each.

    python3 tools/sampling_plans.py

Needs a CUDA card.
"""
import json
import sys
from pathlib import Path

V = 50304
SETTINGS = (("t0.8 k20 p0.95", 0.8, 20, 0.95), ("t1.0", 1.0, 0, 1.0))


def main():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sampling_plans: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    dev = torch.device("cuda", torch.cuda.current_device())
    fits = sm.device_fits(dev, V)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "cluster_fits": fits,
                      "floor_ms": cs._time_rotating(
                          [lambda: torch.cuda._sleep(1)])}), flush=True)
    launch = sm._kernel()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for R in (1, 8, 32, 64):
        copies = max(2, -(-64 * 2 ** 20 // (R * V * 4)))
        logits = [torch.randn(R, V, generator=gen, device="cuda") * 3
                  for _ in range(copies)]
        seeds = torch.arange(1, R + 1, dtype=torch.int32, device="cuda")
        pos = torch.arange(R, dtype=torch.int32, device="cuda")
        out = torch.empty(R, dtype=torch.int32, device="cuda")
        for label, t, k, p in SETTINGS:
            plan = sm.sampling_plan(R, V, fits, k)
            want = sm.sample_rows(logits[0], t, k, p, seeds=seeds, pos=pos)
            times = {}
            for C in sm.CLUSTER_SIZES:
                L = -(-V // (4 * C)) * 4
                if sm.SMEM_FIXED + 4 * L > sm.SMEM_LIMIT or not fits.get(C):
                    continue

                def call(x, C=C, L=L):
                    rc = launch(
                        x.data_ptr(), R, V, L, C, 1, float(np.float32(t)), k,
                        int(p < 1.0), float(np.float32(p)), sm.mass_bits(V),
                        seeds.data_ptr(), pos.data_ptr(), 1, None,
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"sampling launch: code {rc}")

                call(logits[0])
                if not torch.equal(out, want):
                    raise AssertionError(f"R {R} {label} C {C}: tokens "
                                         f"differ from the plan's")
                times[C] = {"ms": cs._time_rotating(
                                [lambda x=x: call(x) for x in logits],
                                reps=60),
                            "waves": -(-R // fits[C]), "blocks": R * C}
            print(json.dumps({"R": R, "V": V, "setting": label,
                              "plan_clusters": plan["clusters"],
                              "by_cluster_size": times}), flush=True)
        del logits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
