"""The backtrace pass's kernel (vit_bt_kernel: K2, K3) against its
roofline: the operations and bytes of the cells the program counted at
its launches (rooflines/vit_bt_kernel.py) at the card's published peaks,
over the kernel's traced device time."""

import json
import os
import re


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    rl = os.path.join(ctx["bench_dir"], "rooflines")
    mod = ctx["load_module"](os.path.join(rl, "vit_bt_kernel.py"))
    with open(os.path.join(rl, "peaks.json")) as f:
        peaks = json.load(f)
    pat = re.compile(mod.KERNEL)
    seconds = sum(v for k, v in tr["kernels"].items() if pat.search(k))
    work = mod.work(ctx["timers"])
    if not seconds or work is None:
        return None
    ops, nbytes = work
    least = max(ops / peaks[mod.PEAK], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
