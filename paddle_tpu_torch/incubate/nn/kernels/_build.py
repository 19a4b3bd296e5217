"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``paddle_tpu_torch/_build/`` under a name that carries
a hash of the source and of the shared headers ``csrc/*.cuh``, so a
changed source or header rebuilds and an unchanged one is loaded as it
is.  Nothing is built at import: the first launch of a
kernel builds it.  :func:`build` starts one ``nvcc`` per source, all at
once, so a caller that needs several kernels pays for the slowest one.

The library directory is :data:`BUILD_DIR`; :func:`set_build_dir` points
it elsewhere (``jit.loop.maybe_enable_compile_cache``, the port's
counterpart of JAX's persistent compilation cache): a second process
given the same directory finds every library under its hash and runs no
``nvcc``.  :data:`BUILD_STATS` counts the sources compiled in this
process and the seconds their builds took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build", "load", "set_build_dir", "BUILD_DIR", "BUILD_STATS",
           "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}

#: sources compiled by this process, and the wall seconds of those builds
BUILD_STATS = {"builds": 0, "seconds": 0.0}


def set_build_dir(path) -> Path:
    """Build into and load from ``path`` from now on (libraries already
    loaded stay loaded); returns it."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    return BUILD_DIR


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "paddle_tpu_torch are built from source at first use and need "
        "the CUDA toolkit")


def _target(name: str) -> Path:
    """The library path of ``csrc/<name>.cu``: its name carries a hash
    of the source, of every header of ``csrc/`` (any source may include
    one) and of the flags, so a change to any of them rebuilds."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns
    {name: library path}.  Raises with the compiler's output if any
    build fails."""
    targets = {n: _target(n) for n in names}
    missing = [n for n, lib in targets.items() if not lib.exists()]
    if not missing:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, targets[name])   # atomic: readers never see half
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
    BUILD_STATS["builds"] += len(procs)
    BUILD_STATS["seconds"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
