"""``row_gemm`` under every cluster size the card fits, and the launch floor.

For gpt3_1p3b's five decode products (bf16; the head from ``wte.t()``
with float32 output) at M 8, 32, 128 and 256, times the kernel with each
K split count (cluster size) of ``row_gemm.CLUSTER_SIZES`` that fits the
card, over rotating weight copies (``chip_smoke._time_rotating``, the
method of ``chip_smoke.py``'s ``row_gemm`` phase), and marks the one
``row_gemm_plan`` takes.  Also prints the card's cluster fits and the
CUDA-event time of a minimal kernel (a one-cycle ``torch.cuda._sleep``),
the floor under every time of that method.  One JSON line each.

    python3 tools/row_gemm_plans.py

Needs a CUDA card.
"""
import json
import sys
from pathlib import Path


def main():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("row_gemm_plans: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = rg.device_card(dev)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "sms": card[0], "cluster_fits": card[1],
                      "floor_ms": cs._time_rotating(
                          [lambda: torch.cuda._sleep(1)])}), flush=True)
    launch = rg._kernel()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, K, N in cs.ROW_GEMM_SHAPES:
        head = name == "head"
        out_dtype = torch.float32 if head else torch.bfloat16
        copies = max(2, -(-160_000_000 // (2 * K * N)))
        ops = [cs._row_gemm_operands(gen, K, N, torch.bfloat16, head)
               for _ in range(copies)]
        plan = rg.row_gemm_plan(8, K, N, torch.bfloat16, card)
        n_tiles, k_stages = plan["n_tiles"], plan["k_stages"]
        for M in (8, 32, 128, 256):
            xs = [x[:M].contiguous() for x, _ in ops]
            outs = [torch.empty((M, N), dtype=out_dtype, device="cuda")
                    for _ in ops]
            times = {}
            for c in rg.CLUSTER_SIZES:
                fit = card[1].get(c, 0)
                if c > k_stages or fit < 1:
                    continue
                per = -(-n_tiles // min(fit, n_tiles))
                clusters = -(-n_tiles // per)

                def call(x, w, y, c=c, clusters=clusters):
                    nk = rg.weight_layout(w) == "nk"
                    rc = launch(
                        x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, int(nk),
                        int(head), M, K, N, w.stride(1) if nk else w.stride(0),
                        c, clusters, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"row_gemm launch: code {rc}")

                times[c] = {
                    "ms": cs._time_rotating(
                        [lambda x=x, w=w, y=y: call(x, w, y)
                         for x, (_, w), y in zip(xs, ops, outs)]),
                    "sms": clusters * c,
                    "stages_per_sm": per * -(-k_stages // c)}
            print(json.dumps({"name": name, "M": M, "K": K, "N": N,
                              "plan_splits": plan["splits"],
                              "by_cluster_size": times}), flush=True)
        del ops, xs, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
