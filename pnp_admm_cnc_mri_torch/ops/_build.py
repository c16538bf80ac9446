"""Builds the package's CUDA sources with nvcc into shared libraries.

A source ``csrc/<name>.cu`` becomes ``_build/lib<name>.so`` (``_build/``
is git-ignored) at first use, with a plain C interface that the wrappers
load through ctypes. The library is rebuilt when the hash of the source and
its own flags changes (kept in ``_build/lib<name>.sha256``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path
import subprocess

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# Flags of one source beyond NVCC_FLAGS. admm_tail: --fmad=false, no
# multiply-add contraction, so its kernels round where their plain PyTorch
# versions round (they are compared bit for bit). admm_iteration,
# admm_iteration_cluster and admm_iteration_mixed keep the contraction:
# their transforms are held to a tolerance, and split multiply-adds would
# roughly halve their rate.
SOURCE_FLAGS = {"admm_tail": ("--fmad=false",), "admm_iteration": (), "admm_iteration_cluster": (),
                "admm_iteration_mixed": ()}
NVCC_TIMEOUT_S = 600


def flags(name: str) -> tuple:
    """nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default location."""
    candidates = [
        Path(os.environ.get("CUDA_HOME", "")) / "bin" / "nvcc" if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for path in candidates:
        if path and Path(path).is_file():
            return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Path of ``lib<name>.so``, compiling ``csrc/<name>.cu`` if it is
    missing or stale. Raises with nvcc's output if the compile fails."""
    src = CSRC_DIR / f"{name}.cu"
    cflags = flags(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(cflags).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.sha256"
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc(), *cflags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode} building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib
