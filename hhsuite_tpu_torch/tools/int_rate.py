"""Issue rate of the card's integer instruction forms that the prefilter
kernels' bound counts (``chip_smoke.py``: ``PEAK_INT32``, ``OPS_K4``,
``OPS_K5``): a 3-input add (IADD3, the INT32 pipe), the fused add and
min/max (VIADDMNMX) and the packed 16x2 forms of Hopper's DPX functions
(two 16-bit cells a register).  ``int_rate.cu`` runs each form in a
kernel of independent operations at full occupancy; the rate is the
form's instructions in the built SASS (``cuobjdump``) times the loop
trips over the time of the launches (CUDA events).  Needs a CUDA card
and ``nvcc``::

    python -m hhsuite_tpu_torch.tools.int_rate

Prints one line a form and, as the last line, one JSON object
``{"card": ..., "forms": {form: {...}}}``.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys

# (form, the SASS opcode it must compile to)
FORMS = (("iadd3", "IADD3"), ("addmax", "VIADDMNMX"),
         ("addmin2", "VIADDMNMX.S16x2"), ("addmax2", "VIADDMNMX.S16x2.RELU"),
         ("max2", "VIMNMX.S16x2.RELU"))
THREADS = 256


def sass_opcodes(so_path: str) -> dict:
    """{op index: Counter of SASS opcodes} of each rate_kernel<op> in a
    built library."""
    from hhsuite_tpu_torch.device import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"rate_kernelILi(\d)E", body.split("\n", 1)[0])
        if m:
            out[int(m.group(1))] = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
                body))
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    from hhsuite_tpu_torch.device import build_cuda_library

    if not torch.cuda.is_available():
        print("int_rate: no CUDA card", file=sys.stderr)
        return 2
    info = build_cuda_library("int_rate", os.path.dirname(__file__))
    lib = ctypes.CDLL(info.path)
    lib.int_rate_time.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_float)]
    lib.int_rate_error_string.restype = ctypes.c_char_p
    per_trip = lib.int_rate_ops_per_trip()
    opcodes = sass_opcodes(info.path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, trips, reps = 16 * sms, 2000, 5
    forms = {}
    for op, (form, opcode) in enumerate(FORMS):
        n_sass = opcodes.get(op, {}).get(opcode, 0)
        ms = ctypes.c_float()
        rc = lib.int_rate_time(op, blocks, THREADS, trips, reps,
                               ctypes.byref(ms))
        if rc != 0:
            raise RuntimeError(f"int_rate {form}: "
                               f"{lib.int_rate_error_string(rc).decode()}")
        instr = float(blocks) * THREADS * trips * n_sass * reps
        rate = instr / (ms.value * 1e-3)
        forms[form] = dict(opcode=opcode, sass_per_trip=n_sass,
                           ops_per_trip=per_trip, ms=ms.value / reps,
                           per_s=rate, per_sm_clock=None)
        print(f"int_rate {form}: {opcode} {n_sass} a trip (source "
              f"{per_trip}), {ms.value / reps:.3f} ms a launch, "
              f"{rate:.4e} instructions/s; SASS mix "
              + ", ".join(f"{k} {v}" for k, v in
                          sorted(opcodes.get(op, {}).items())
                          if k[0] in "IV"), flush=True)
    card = card_line()
    mhz = float(card.split(",")[2].split()[0])
    for rec in forms.values():
        rec["per_sm_clock"] = rec["per_s"] / (sms * mhz * 1e6)
    print(card)
    print(json.dumps({"card": card, "sms": sms, "forms": forms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
