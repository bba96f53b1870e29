"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), named
by a hash of the source and the flags, under ``build/kernels/`` at the root
of the checkout.  A library whose name is already there is reused; a
changed source gets a new name, so a stale build is never loaded.  Nothing
is compiled at import time: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("merge.cu", "flash_attention.cu", "quantize.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor /usr/local/cuda/bin); the "
        "port's CUDA kernels need the CUDA toolkit to build"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(sources: Sequence[str] = SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns ``{source: compiler output}`` (with
    ``verbose``, ptxas's per-kernel registers and spills); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source in sources:
        target = library_path(source)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((source, target, tmp, proc))
    logs, failed = {}, []
    for source, target, tmp, proc in running:
        out, _ = proc.communicate()
        logs[source] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<source>``, building it first if missing."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
