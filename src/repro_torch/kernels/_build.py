"""Builds the port's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
loaded with ``ctypes``. Libraries are keyed by a hash of the sources and
the flags and kept in the package's ``_lib`` directory (ignored by git), so
a fresh checkout builds on its first call and later calls in the same
checkout reuse the build. Sources build in parallel: one ``nvcc`` process
each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_DIR = Path(__file__).resolve().parent / "_lib"
SOURCES = ("gossip_cycle", "quantize_send", "voted_predict", "pegasos_merge",
           "flash_attention", "flash_attention_hopper")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# the sources this process compiled, in order (telemetry's
# ``compile_cache_sizes`` counts them with the libraries loaded)
built: List[str] = []


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (searched PATH and CUDA_HOME); the "
                       "port's CUDA kernels are built with it at first use")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by a hash of the
    CUDA sources and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return LIB_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source that has no current build, all at once.

    Returns each compiled source's compiler output (``-Xptxas -v`` prints
    registers, shared memory and spills per kernel); raises with that
    output when a compile fails."""
    names = tuple(SOURCES if names is None else names)
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            built.append(name)
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.is_file():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
