"""Device choice and the CUDA kernel build.

* :func:`resolve_device` — the device an entry point runs on: ``cuda``
  unless the caller passes ``device="cpu"`` (or the CLI environment sets
  ``HHSUITE_TPU_TORCH_DEVICE=cpu``).  Asking for CUDA on a machine with
  no card raises; nothing falls back to the CPU quietly.
* :func:`cuda_library` — compile a ``csrc/*.cu`` source with ``nvcc``
  for ``sm_90a`` into a plain-C shared library under ``build/`` (at
  first use, keyed by the source's content) and load it with ctypes.
* :func:`on_card` / :func:`launch_on` — a device as the current CUDA
  device, for a library entry's launch (or a mesh shard's work).

Importing this module turns TF32 off for matmuls and cuDNN, so any f32
product on the card runs in full f32.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

import torch

from .profiling import annotate, stage_add

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICE_ENV = "HHSUITE_TPU_TORCH_DEVICE"
PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# -fmad=false: nvcc contracts a*b+c into FMA by default, which breaks the
# bit-exact log2 polynomials and the profile-dot summation tree.  Never
# --use_fast_math (it changes denormal flushing and division).
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")


def resolve_device(device=None) -> torch.device:
    """``device`` (str or torch.device), else $HHSUITE_TPU_TORCH_DEVICE,
    else ``cuda``; raises when CUDA is asked for and absent."""
    if device is None:
        device = os.environ.get(DEVICE_ENV, "").strip() or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hhsuite_tpu_torch: no CUDA device is available; pass "
                "device='cpu' (or set HHSUITE_TPU_TORCH_DEVICE=cpu) to "
                "run the plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_card(dev):
    """``torch.cuda.device(dev)`` for a card, a null context for any
    other device."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def launch_on(dev, entry, *args):
    """``entry(*args)`` (a ctypes kernel entry) under :func:`on_card`:
    the library's CUDA runtime launches on the current device, which
    must be the card that holds the tensors and the stream passed in
    ``args`` (the CPU builds of the tests' emulation run as they are)."""
    with on_card(dev):
        return entry(*args)


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


class BuildInfo:
    """What one library build did: output path, seconds, compiler log
    (a reused build carries the log of the build that made it)."""

    def __init__(self, path: str, seconds: float, log: str, cached: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.cached = cached


def build_cuda_library(name: str, src_dir: str = CSRC_DIR) -> BuildInfo:
    """Compile ``<src_dir>/<name>.cu`` (``csrc/`` by default) into
    ``build/lib<name>-<hash>.so``.

    The file name carries a hash of the source and flags, so an edited
    source rebuilds and an unchanged one is reused.  The compiler writes
    to a per-process temporary name that is renamed into place, so
    concurrent builds never load a half-written library."""
    src = os.path.join(src_dir, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        log = ""
        if os.path.exists(so + ".log"):
            with open(so + ".log") as f:
                log = f.read()
        return BuildInfo(so, 0.0, log, True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    stage_add("kernel_builds")
    t0 = time.perf_counter()
    with annotate("kernel_build"):
        res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}\n"
                           f"{res.stderr}")
    log = res.stdout + res.stderr
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", so + ".log")
    os.replace(tmp, so)
    return BuildInfo(so, secs, log, False)


_LIBS: Dict[str, Tuple[ctypes.CDLL, BuildInfo]] = {}
_LIBS_LOCK = threading.Lock()


def cuda_library(name: str) -> Tuple[ctypes.CDLL, BuildInfo]:
    """The loaded ``csrc/<name>.cu`` library (built on first call) and
    its build record."""
    with _LIBS_LOCK:
        hit = _LIBS.get(name)
        if hit is None:
            info = build_cuda_library(name)
            hit = _LIBS[name] = (ctypes.CDLL(info.path), info)
        return hit
