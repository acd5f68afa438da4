"""Runtime-environment block of a training log: the port's counterpart
of ``iif_tpu/utils/env.py`` (the reference's ``mmdet/utils/
collect_env.py``), with PyTorch, CUDA and the card in place of JAX and
the TPU. ``python -m iif_torch.utils.env`` prints it."""
from __future__ import annotations

import platform
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch


def _pkg_version(name: str) -> str:
    try:
        import importlib.metadata as md

        return md.version(name)
    except Exception:
        return "n/a"


def _git_hash(short: int = 7) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=Path(__file__).resolve().parents[2])
        return out.stdout.strip()[:short] or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def collect_env() -> Dict[str, str]:
    """Ordered env-info dict."""
    info: Dict[str, str] = {
        "sys.platform": sys.platform,
        "Python": sys.version.replace("\n", ""),
        "CPU": platform.processor() or platform.machine(),
        "PyTorch": torch.__version__,
        "CUDA": str(torch.version.cuda),
        "numpy": _pkg_version("numpy"),
        "iif_torch": "0.1+" + _git_hash(),
    }
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        info["Devices"] = f"{len(names)}x {names[0]}"
    else:
        info["Devices"] = "no CUDA device"
    return info


def env_info_str() -> str:
    """One line a field, as the reference logs it."""
    return "\n".join(f"{k}: {v}" for k, v in collect_env().items())


if __name__ == "__main__":
    print(env_info_str())
