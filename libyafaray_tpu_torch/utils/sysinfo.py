"""Build and system metadata: counterpart of `libyafaray_tpu/utils/sysinfo.py`
(the reference's buildinfo and sysInfo modules, src/common/version_build_info.cc
and src/common/sysinfo.cc) for the port. The compiler is the Python, torch,
torch's CUDA and nvcc stack; the device inventory is the CUDA devices; the
git commit is read from the working tree when there is one.

`get_params()` mirrors buildinfo::getAllBuildInfoVector()'s key / value list
under the JAX package's keys. Nothing here initializes CUDA until a function
that lists the devices is called.
"""
from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys
from typing import Dict, List

import torch

from .. import __version__

_VER = tuple(int(x) for x in __version__.split(".")[:3])


def get_version_string() -> str:
    git = get_git_commit()
    return __version__ + (f"+g{git[:8]}" if git else "")


def get_version_major() -> int:
    return _VER[0]


def get_version_minor() -> int:
    return _VER[1]


def get_version_patch() -> int:
    return _VER[2]


def get_git_commit() -> str:
    """The working tree's commit, empty outside a git checkout (the
    reference bakes it in at configure time)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if shutil.which("git") is None:
        return ""
    out = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"],
                         capture_output=True, text=True, timeout=5)
    return out.stdout.strip() if out.returncode == 0 else ""


def get_architecture() -> str:
    return platform.machine()


def get_operating_system() -> str:
    return f"{platform.system()} {platform.release()}"


def _nvcc_release() -> str:
    """nvcc's release line ("Cuda compilation tools, release 12.9, ...")
    where the CUDA toolkit is installed, else ""."""
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        path = shutil.which("nvcc")
    if path is None:
        return ""
    out = subprocess.run([path, "--version"], capture_output=True, text=True,
                         timeout=30)
    lines = [ln for ln in out.stdout.splitlines() if "release" in ln]
    return lines[-1].strip() if out.returncode == 0 and lines else ""


def get_compiler() -> str:
    """The port's 'compiler': Python, torch, torch's CUDA and nvcc (when
    the toolkit is installed)."""
    parts = [f"python {sys.version.split()[0]}", f"torch {torch.__version__}",
             f"torch CUDA {torch.version.cuda}"]
    nvcc = _nvcc_release()
    if nvcc:
        parts.append(f"nvcc {nvcc}")
    return ", ".join(parts)


def get_devices() -> List[str]:
    """The CUDA devices by name ("cuda:0 NVIDIA H100 80GB HBM3"): the
    thread-count analogue (sysinfo::getNumSystemThreads). Empty on a host
    without a card; the CPU is not listed as a device."""
    if not torch.cuda.is_available():
        return []
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())]


def get_num_devices() -> int:
    return len(get_devices())


def get_ram_gb() -> float:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 0.0
    return round(pages * page_size / 2 ** 30, 1)


def get_params() -> Dict[str, str]:
    """The key / value build and system table (getAllBuildInfoVector)."""
    return {
        "version": get_version_string(),
        "version_major": str(get_version_major()),
        "version_minor": str(get_version_minor()),
        "version_patch": str(get_version_patch()),
        "git_commit": get_git_commit(),
        "architecture": get_architecture(),
        "operating_system": get_operating_system(),
        "compiler": get_compiler(),
        "num_devices": str(get_num_devices()),
        "ram_gb": str(get_ram_gb()),
    }


def sysinfo_string() -> str:
    """The one-line render-info summary (the reference's render-settings
    string, scene.cc:155)."""
    devs = get_devices()
    dev = devs[0] if devs else "no-device"
    return (f"libyafaray_tpu_torch {get_version_string()} | {dev} x"
            f"{len(devs)} | {get_operating_system()} "
            f"{get_architecture()} | {get_compiler()}")
