"""The port stands alone: ``hhsuite_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package, and the entry points
refuse to run on a missing card instead of falling back to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hhsuite_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import hhsuite_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hhsuite_tpu_torch.__path__,
                                               "hhsuite_tpu_torch.")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
import chip_smoke
chip_smoke.kernel_counters()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hhsuite_tpu"))
print(len(names), bad)
"""


def test_import_everything_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 30
    assert bad.strip() == "[]"


def _sources():
    for root, _dirs, files in os.walk(PKG):
        if "build" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_static_scan_finds_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)|hhsuite_tpu\.|"
                     r"import hhsuite_tpu\b|from hhsuite_tpu\b", re.M)
    hits = []
    for path in _sources():
        with open(path) as f:
            for m in pat.finditer(f.read()):
                hits.append((os.path.relpath(path, REPO), m.group(0)))
    assert not hits, hits


def test_run_hhsearch_without_card_raises(monkeypatch):
    from hhsuite_tpu_torch.constants import Parameters
    from hhsuite_tpu_torch.device import DEVICE_ENV, resolve_device
    from hhsuite_tpu_torch.search.engine import run_hhsearch

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_hhsearch(Parameters.hhsearch_defaults(), ">q\nACDE\n", None)
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert resolve_device().type == "cpu"


def test_device_module_turns_tf32_off():
    import hhsuite_tpu_torch.device  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_native_loader_reports_build_failure(monkeypatch, tmp_path):
    """The host library builds into the port's build directory; a failed
    build is reported (load_error / require), not silently swallowed."""
    from hhsuite_tpu_torch import native

    assert native.build().startswith(
        os.path.join(PKG, "build", "_hhsuite_native-"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_cached", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_cmd",
                        lambda src, so: ["g++", "-x", "c++", "-c",
                                         "/dev/null", "-DX", "--no-such"])
    assert native.load() is None
    assert "g++ failed" in native.load_error()
    with pytest.raises(RuntimeError, match="native host library"):
        native.require()
