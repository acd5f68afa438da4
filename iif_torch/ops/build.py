"""Build the port's CUDA kernels from the sources under ``iif_torch/csrc``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``. Nothing links against PyTorch's
headers, so a build takes seconds. Libraries go to
``build/iif_torch_kernels/`` at the repo root (listed in ``.gitignore``),
named by a hash of the source, the headers it shares (``csrc/*.cuh``) and
the flags, so a changed source builds anew and an unchanged one is loaded
as it is.

Nothing is compiled at import: the first call that launches a kernel
builds it, and ``build_all`` builds every kernel up front, one ``nvcc``
call per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = REPO_ROOT / "iif_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "iif_torch_kernels"

# Flags per source. -fmad=false keeps the RoIAlign sample geometry in the
# float op order of the plain version (roi_align_common.cuh).
_ROI_ALIGN_FLAGS = ["-O3", "-std=c++17",
                    "-gencode", "arch=compute_90a,code=sm_90a",
                    "-fmad=false", "-Xptxas", "-v"]
NVCC_FLAGS = {
    "roi_align_ml": _ROI_ALIGN_FLAGS,      # K1, K2
    "roi_align": _ROI_ALIGN_FLAGS,         # K3, K4
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers and the flags."""
    sources = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(
        b"".join(src.read_bytes() for src in sources)
        + " ".join(NVCC_FLAGS[name]).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _command(name: str, out: Path) -> list:
    return ([nvcc_path()] + NVCC_FLAGS[name]
            + ["-shared", "-Xcompiler", "-fPIC", "-o", str(out),
               str(CSRC / f"{name}.cu")])


def build(name: str) -> str:
    """Compile kernel ``name`` unless it is built already. Returns its
    ``ptxas`` report (empty when it was cached)."""
    out = _target(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(_command(name, tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def build_all() -> Dict[str, str]:
    """Build every kernel, one ``nvcc`` a source, all at once; each one's
    ``ptxas`` report by name."""
    with ThreadPoolExecutor(len(NVCC_FLAGS)) as pool:
        return dict(zip(NVCC_FLAGS, pool.map(build, NVCC_FLAGS)))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
