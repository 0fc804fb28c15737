"""Native (C++) host runtime with build-on-demand loading.

`load()` returns the compiled `_hhsuite_native` module, building it with
g++ on first use into the package's ``build/`` directory (keyed by a hash
of the source, so an edited source rebuilds), or None when it cannot be
built — the host callers then run their pure-Python implementations.
The reason is kept: `load_error()` returns it, and `require()` raises
with it, for callers that must not time a run whose host path dropped
to pure Python.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "hhsuite_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")

_cached = None
_tried = False
_error: Optional[str] = None
_LOAD_LOCK = threading.Lock()   # one build/load across threads


def _cmd(src: str, so: str):
    inc = sysconfig.get_paths()["include"]
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{inc}",
            src, "-o", so]


def _so_path() -> str:
    tag = f"{sys.version_info.major}{sys.version_info.minor}"
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            _cmd("", "")).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR,
                        f"_hhsuite_native-{digest}.cpython-{tag}.so")


def build(verbose: bool = False) -> str:
    """Compile the extension (unless built already); returns the .so
    path.  Raises CalledProcessError with the compiler's output."""
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = _cmd(_SRC, tmp)
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    from ..profiling import annotate, stage_add

    stage_add("kernel_builds")
    with annotate("kernel_build"):
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise subprocess.CalledProcessError(res.returncode, cmd, res.stdout,
                                            res.stderr)
    os.replace(tmp, so)
    return so


def load():
    """The compiled module, or None if it cannot be built or loaded
    (see :func:`load_error`)."""
    global _tried
    if _tried:
        return _cached
    with _LOAD_LOCK:
        if not _tried:
            _load()
            _tried = True
    return _cached


def _load() -> None:
    global _cached, _error
    import importlib.util

    try:
        so = build()
        spec = importlib.util.spec_from_file_location("_hhsuite_native", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _cached = mod
    except subprocess.CalledProcessError as e:
        _error = f"g++ failed ({e.returncode}): {e.stderr or e.stdout}"
    except (OSError, ImportError) as e:
        _error = f"{type(e).__name__}: {e}"


def load_error() -> Optional[str]:
    """Why :func:`load` returned None (None if it loaded or was not
    tried)."""
    return _error


def require():
    """The compiled module; raises RuntimeError with the build error
    when the host path would fall back to pure Python."""
    mod = load()
    if mod is None:
        raise RuntimeError(f"native host library unavailable: {_error}")
    return mod
