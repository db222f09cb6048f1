"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` inside the
package at first use, then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source is never served by a stale
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, under ``$CUDA_HOME``, or in
    ``/usr/local/cuda``."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(*names: str) -> dict:
    """Compile each ``csrc/<name>.cu`` whose current library is missing,
    one ``nvcc`` per source, all started together.

    Returns ``{name: (library path, compiler log)}``; the log is empty for
    a library that was already built. Each library appears by an atomic
    rename. Raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = (path, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        # a file, not a pipe: a pipe could fill while we wait on another nvcc
        log = tempfile.TemporaryFile("w+", dir=BUILD_DIR)
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, log, proc))
    failed = []
    for name, path, tmp, log, proc in running:
        rc = proc.wait()
        with log:
            log.seek(0)
            text = log.read()
        if rc != 0:
            failed.append(f"nvcc failed for {name}:\n{text}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        out[name] = (path, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    path, _ = build(name)[name]
    return ctypes.CDLL(str(path))
