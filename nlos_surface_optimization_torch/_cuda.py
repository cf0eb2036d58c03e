"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and is compiled
by ``nvcc`` for sm_90a into ``_build/<name>-<hash>.so`` (the hash covers the
source, the local headers it includes and the flags, so an edited source
or header rebuilds), then loaded with
ctypes.  Nothing is built or loaded at import time: the first launch on a
CUDA tensor builds what it needs, and ``build_all`` builds every kernel at
once, one nvcc process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
KERNELS = ("occluded_splat", "backward_face_sums", "segment_occluded",
           "sample_rays")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

# -fmad=false: every product and sum is rounded on its own, as in the
# kernels' plain PyTorch versions (the occlusion test must match exactly).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _sources(path: str, seen: List[str]) -> List[str]:
    """path and every local header it includes, recursively."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as fh:
        for inc in _INCLUDE.findall(fh.read()):
            _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(os.path.join(CSRC, name + ".cu"), []):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    os.makedirs(BUILD, exist_ok=True)
    target = _target(name)
    if os.path.exists(target):
        return target, None
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    build_log[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names=KERNELS) -> float:
    """Build every named kernel in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    jobs: List = [(n, *_start(n)) for n in names]
    for name, target, job in jobs:
        _finish(name, target, job)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        target, job = _start(name)
        _finish(name, target, job)
        lib = ctypes.CDLL(target)
        _libs[name] = lib
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def sm_count(device) -> int:
    """Streaming multiprocessors of the card that holds ``device``."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
