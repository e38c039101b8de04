"""Build and load the package's CUDA kernels (``nvcc`` + ``ctypes``).

Each ``csrc/*.cu`` source compiles, on first use, into a shared library
with a plain C interface under ``build/kernels/`` at the repository root
(or ``$REPRO_TORCH_BUILD_DIR``).  The library name carries a hash of the
source, the ``csrc/*.cuh`` headers it includes and the flags
(:func:`build_tag`), so an edited source or header never loads a stale
build.  Nothing
here runs at import time: a host without ``nvcc`` or a card imports the
package and runs the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..obs import buildprof

__all__ = ["NVCC_FLAGS", "build", "build_tag", "load"]

#: sm_90a, no fast math, no FMA contraction (bit-exact float arithmetic)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent / "csrc"
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def build_tag(source: str, csrc: Path = _CSRC) -> str:
    """The hash that names ``source``'s library: its bytes, those of every
    header of ``csrc`` it includes (``#include "x.cuh"``, followed
    through headers), and the flags."""
    h = hashlib.sha256()
    seen, todo = set(), [source]
    while todo:
        name = todo.pop(0)
        if name in seen or not (csrc / name).is_file():
            continue
        seen.add(name)
        text = (csrc / name).read_bytes()
        h.update(name.encode() + b"\0" + text + b"\0")
        todo += [m.decode() for m in _INCLUDE.findall(text)]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` (if not built yet); returns the library
    path and the compiler's ``-Xptxas -v`` report.  An ``nvcc`` run is
    recorded by :mod:`repro_torch.obs.buildprof` when that is enabled."""
    src = _CSRC / source
    tag = build_tag(source)
    out_dir = _build_dir()
    lib = out_dir / f"lib{src.stem}_{tag[:12]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, timeout=600)
        buildprof.record(src.stem, time.perf_counter() - t0, source=source)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        report = proc.stdout + proc.stderr
        log.write_text(report)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, report


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(str(build(source)[0]))
        return _LIBS[source]
