"""The port stands alone: paddle_tpu_torch imports neither jax nor
anything of paddle_tpu, nor ``ml_dtypes``.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``jaxlib``, ``paddle_tpu`` and ``ml_dtypes``, imports every module of
the port, serves one request (again under injected device faults, then
drained, and one through the fused b1 engine on int8 weights), serves a
shared prefix through the prefix cache's host tier in bf16, hands the
engine off mid-run (snapshot, restore) to a successor that finishes it,
takes one train step, one ``partial:1`` step on a prefetched batch with a
save / ``load_latest`` round trip, and runs one llama_tiny ``generate`` on
the CPU.  A source scan checks the import
statements of the package and of the chip scripts (``chip_smoke.py``,
``chip_fused_ab.py``, ``tools/llama_ab.py``, ``tools/serving_ab.py``).
"""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes"}

_CHILD = r"""
import importlib, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)

import numpy as np
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import gpt
cfg = gpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, max_position_embeddings=64)
eng = ContinuousBatchingEngine(gpt.init_params(cfg, 0, device="cpu"), cfg,
                               max_batch=2, max_len=32, device="cpu")
rid = eng.submit(np.arange(5), max_new=4)
out = eng.run()
assert eng.status(rid) == "DONE" and len(out[rid]) == 4, out

from paddle_tpu_torch.testing.faults import inject_engine_faults
eng.step_timeout = 30.0
with inject_engine_faults(eng, fail_times=1) as inj:
    again = eng.submit(np.arange(5), max_new=4)
    assert eng.drain(timeout=60)[again].tokens == out[rid]
assert inj.injected == {"prefill": 1, "decode": 1}, inj.injected

from paddle_tpu_torch.incubate.nn.kernels import fused_decode
from paddle_tpu_torch.inference.serving import FusedB1Engine
qp = gpt.quantize_decode_params(gpt.init_params(cfg, 0, device="cpu"), cfg)
feng = FusedB1Engine(qp, cfg, max_len=32, kv_dtype="int8", device="cpu")
rid = feng.submit(np.arange(5), max_new=4)
out = feng.run()
assert len(out[rid]) == 4 and fused_decode.LAUNCHES == 0, out

import tempfile
import torch
from paddle_tpu_torch.inference import handoff
bcfg = gpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, max_position_embeddings=64,
                     dtype=torch.bfloat16)
bp = gpt.init_params(bcfg, 0, device="cpu")
def tiered():
    return ContinuousBatchingEngine(bp, bcfg, max_batch=2, max_len=48,
                                    prefix_cache_bytes=1000,
                                    prefix_host_bytes=1 << 20, device="cpu")
shared = np.arange(3, 27)
old = tiered()
rids = [old.submit(np.concatenate([shared, [i, i + 1]]), max_new=6)
        for i in range(3)]
old.step(2)
root = tempfile.mkdtemp()
new = tiered()
rep = handoff.restore(new, handoff.snapshot(old, root))
assert rep.ok and rep.spans_installed > 0, rep
new.run()
tiers = new.metrics()["prefix_tiers"]
assert tiers["reinstalls"] > 0 and tiers["installing"] == 0, tiers

import torch
from paddle_tpu_torch.distributed import hybrid
tcfg = gpt.gpt_tiny(num_layers=2)
step, shard, init_opt = hybrid.build_train_step(tcfg, num_micro=2,
                                                device="cpu")
p = shard(gpt.init_params(tcfg, 0, device="cpu"))
ids = torch.arange(64).reshape(2, 32) % tcfg.vocab_size
loss, p, o = step(p, init_opt(p), ids, ids.roll(-1, 1))
assert torch.isfinite(loss) and int(o["step"]) == 1, loss

from paddle_tpu_torch.distributed import checkpoint as dist_cp
from paddle_tpu_torch.io import prefetch_to_device
pstep, pshard, pinit = hybrid.build_train_step(tcfg, remat="partial:1",
                                               device="cpu")
pp = pshard(gpt.init_params(tcfg, 0, device="cpu"))
state = {"params": pp, "opt": pinit(pp)}
(bids, blab), = prefetch_to_device(iter([(ids.numpy(), ids.roll(-1, 1))]),
                                   device=pstep.data_device)
loss, _, _ = pstep(state["params"], state["opt"], bids, blab)
assert torch.isfinite(loss), loss
ckpt = tempfile.mkdtemp()
dist_cp.save_checkpoint(state, ckpt, 1)
fresh = {"params": pshard(gpt.init_params(tcfg, 1, device="cpu"))}
fresh["opt"] = pinit(fresh["params"])
assert dist_cp.load_latest(fresh, ckpt) == 1
flat = dist_cp.flatten_state_dict
assert all(torch.equal(a, flat(fresh)[0][k])
           for k, a in flat(state)[0].items())

from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope
from paddle_tpu_torch.models import llama
lcfg = llama.llama_tiny(num_layers=2)
toks = llama.generate(llama.init_params(lcfg, 0, device="cpu"),
                      torch.arange(12).reshape(2, 6), lcfg, max_new_tokens=4)
assert toks.shape == (2, 4) and sum(fused_norm_rope.LAUNCHES.values()) == 0
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("modules", len(names))
"""


def test_port_imports_and_serves_with_jax_blocked():
    """Imports, serves and trains with jax and paddle_tpu blocked."""
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 10


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_imports_no_jax_or_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_fused_ab.py",
              ROOT / "tools" / "llama_ab.py", ROOT / "tools" / "serving_ab.py"]
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f) if mod.split(".")[0] in BLOCKED]
    assert len(files) > 10
    assert not bad, bad
