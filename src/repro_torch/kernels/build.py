"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` into ``_build/<name>-<hash>.so`` beside the sources (a
directory git ignores).  The hash covers the source text, every header
under ``csrc/`` that it names with ``#include "..."`` (and theirs), and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  Nothing here runs at import: the CPU tests import every module of
the port, and there is no ``nvcc`` where they run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel: what nvcc printed when this process built it (``-Xptxas -v``:
# registers, shared memory, spills); absent when a built library was reused
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc "
                           "on PATH) — the port's kernels build with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the local headers it includes (each
    once, in the order first named) and ``NVCC_FLAGS``."""
    h = hashlib.sha256()
    seen, todo = set(), [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.is_file():
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(text)]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if it has no
    up-to-date build; raises with nvcc's output if the compile fails."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"{name}-{digest(name)[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} (exit "
                               f"{proc.returncode}):\n{BUILD_LOG[name]}")
        os.replace(tmp, so)   # atomic: concurrent builders agree
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]
