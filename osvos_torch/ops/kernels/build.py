"""Build the port's CUDA sources with nvcc and load them with ctypes, and
find the stream a wrapper launches on.

Each ``osvos_torch/csrc/<name>.cu`` exposes a plain C interface. It is
compiled at first use into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout (``.gitignore`` lists ``build/``), the hash covering the source,
every header beside it (``csrc/*.cuh``, which a source may include) and the
flags, so an edited source or header builds anew. No PyTorch headers are
included, which keeps a build to seconds.
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
from typing import List

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns nvcc's report (ptxas register and spill counts), or an empty
    string when the library was there. Raises with nvcc's stderr if the build
    fails. The library lands under a temporary name and is renamed, so
    processes building at once never load a half-written file.
    """
    so = library_path(name)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(name, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_library(name)
    return ctypes.CDLL(str(library_path(name)))


class launch_stream:
    """``with launch_stream(device) as stream``: the handle of ``device``'s
    current stream, for a launch through ctypes. ``device`` is made the
    current device for the launch only when it is not already: entering
    ``torch.cuda.device`` and building a ``torch.cuda.Stream`` object on
    every launch cost more host time than a kernel's entry point (the host
    split of ``chip_smoke.py``, ``PERF.md``)."""

    __slots__ = ("device", "ctx")

    def __init__(self, device: torch.device):
        self.device = device
        self.ctx = None

    def __enter__(self) -> int:
        index = self.device.index
        if index != torch.cuda.current_device():
            self.ctx = torch.cuda.device(self.device)
            self.ctx.__enter__()
        return torch._C._cuda_getCurrentRawStream(index)

    def __exit__(self, *exc) -> None:
        if self.ctx is not None:
            self.ctx.__exit__(*exc)
