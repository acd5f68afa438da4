"""Build the port's host C++ libraries (``rle.cpp``, ``evalmatch.cpp``).

Each source is compiled by ``g++ -O3 -shared -fPIC`` into
``build/iif_torch_native/`` at the repo root (listed in ``.gitignore``),
named by a hash of the source and the flags, and loaded with ``ctypes``.
Nothing is compiled at import: the first call builds the library. A
build writes a temporary name and renames it into place, so parallel
processes may build at once. A missing compiler or a failed build raises
with the compiler's output; there is no Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = REPO_ROOT / "build" / "iif_torch_native"
FLAGS = ["-O3", "-shared", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _target(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless it is built already; its path."""
    out = _target(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build {name}.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp),
                           str(SRC_DIR / f"{name}.cpp")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``<name>.cpp``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib
