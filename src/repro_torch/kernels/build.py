"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, for Hopper only
(``-gencode arch=compute_90a,code=sm_90a``), into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (override
with ``REPRO_TORCH_BUILD_DIR``).  The hash covers the source and the flags,
so an edited source never loads a stale library.  A build happens at first
use, never at import: the CPU tests import every module on machines without
``nvcc``.  :func:`build_all` starts one ``nvcc`` per source at once.

The sources include no PyTorch header: a file with a plain C interface
builds in seconds, where one that includes ``torch/extension.h`` takes
minutes.  Each launcher returns ``cudaGetLastError()`` so the Python wrapper
can raise on a refused launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (library path, Popen or None, temp output path or None)."""
    src, out = _target(name)
    if out.exists():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> str:
    if proc is None:
        return f"{name}: cached {out.name}"
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half
    return f"{name}: built {out.name}\n{log}"


def build_all(names: List[str]) -> str:
    """Build every named kernel, one nvcc each, all started together.
    Returns the compilers' logs (``-Xptxas -v`` register/smem reports)."""
    started = [(n, *_start(n)) for n in names]
    return "\n".join(_finish(*s) for s in started)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out, proc, tmp = _start(name)
            _finish(name, out, proc, tmp)
            lib = _LIBS[name] = ctypes.CDLL(str(out))
        return lib


def stream_and_device(t) -> Tuple[int, int]:
    """(CUDA stream handle, device index) to launch on for tensor ``t``."""
    import torch

    idx = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.current_stream(idx).cuda_stream, idx


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
