"""The machinery the ablation tools share (``realign_ablation``,
``walk_mac_ablation``): a variant of a kernel source is a text edit of
it, built with the repository's ``nvcc`` flags into
``build/ablation/<variant>/`` (the repository's sources are not
touched), its ptxas registers and spills read from the build's log, and
its launches timed with CUDA events."""

from __future__ import annotations

import concurrent.futures
import os
import re
import subprocess


def edit(src: str, old: str, new: str) -> str:
    """``src`` with the one occurrence of ``old`` replaced by ``new``;
    ValueError when ``old`` is not there exactly once (not the source
    the variant was written for)."""
    if src.count(old) != 1:
        raise ValueError(f"not the source this variant edits: "
                         f"{old.strip().splitlines()[0]!r} is not there "
                         "once")
    return src.replace(old, new)


def build(variants: dict) -> dict:
    """Build ``{variant: (library name, source)}`` in parallel, each as
    ``build/ablation/<variant>/<library name>.cu``; returns ``{variant:
    BuildInfo}``."""
    from ..device import BUILD_DIR, build_cuda_library

    dirs = {}
    for name, (lib, src) in variants.items():
        d = os.path.join(BUILD_DIR, "ablation", name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, lib + ".cu"), "w") as f:
            f.write(src)
        dirs[name] = (lib, d)
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        return dict(zip(dirs, ex.map(lambda ld: build_cuda_library(*ld),
                                     dirs.values())))


def ptxas(log: str, kernel: str) -> str:
    """"<registers> registers, <bytes> bytes spilled" of the first kernel
    whose mangled name holds ``kernel`` in a build's ptxas log."""
    m = re.search(r"Function properties for \w*" + kernel + r"\w*\s*\n"
                  r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
                  log, re.S)
    return f"{m.group(2)} registers, {m.group(1)} bytes spilled" if m else "?"


def timed(launch, reps: int) -> float:
    """ms a launch: one warm-up, then CUDA events over ``reps``."""
    import torch

    launch()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
