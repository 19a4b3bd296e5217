"""The port stands alone: paddle_tpu_torch imports neither jax nor
anything of paddle_tpu.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``jaxlib`` and ``paddle_tpu``, imports every module of the port, serves
one request (and one through the fused b1 engine on int8 weights),
takes one train step and runs one llama_tiny ``generate`` on the CPU.  A source scan checks the import
statements of the package and of the chip scripts (``chip_smoke.py``,
``chip_fused_ab.py``).
"""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = {"jax", "jaxlib", "paddle_tpu"}

_CHILD = r"""
import importlib, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "paddle_tpu"}

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

from paddle_tpu_torch.incubate.nn.kernels import fused_decode
from paddle_tpu_torch.inference.serving import FusedB1Engine
qp = gpt.quantize_decode_params(gpt.init_params(cfg, 0, device="cpu"), cfg)
feng = FusedB1Engine(qp, cfg, max_len=32, kv_dtype="int8", device="cpu")
rid = feng.submit(np.arange(5), max_new=4)
out = feng.run()
assert len(out[rid]) == 4 and fused_decode.LAUNCHES == 0, out

import torch
from paddle_tpu_torch.distributed import hybrid
tcfg = gpt.gpt_tiny(num_layers=2)
step, shard, init_opt = hybrid.build_train_step(tcfg, num_micro=2,
                                                device="cpu")
p = shard(gpt.init_params(tcfg, 0, device="cpu"))
ids = torch.arange(64).reshape(2, 32) % tcfg.vocab_size
loss, p, o = step(p, init_opt(p), ids, ids.roll(-1, 1))
assert torch.isfinite(loss) and int(o["step"]) == 1, loss

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
    files += [ROOT / "chip_smoke.py", ROOT / "chip_fused_ab.py"]
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f) if mod.split(".")[0] in BLOCKED]
    assert len(files) > 10
    assert not bad, bad
