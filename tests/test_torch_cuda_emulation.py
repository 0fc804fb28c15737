"""``csrc/viterbi.cu`` compiled with g++ against a CPU stand-in for the
CUDA runtime (``tests/cuda_emu/cuda_runtime.h``: threads, block
barriers, warp shuffles) and run on the CPU through the port's own
launch code (``ops/viterbi_lanes.py:launch_bt`` and ``launch_score``).

The card is where the kernels are held to their plain versions
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this runs the same
source's control flow here: the K2/K3 wavefront (group widths, passes,
the pass boundary, the template ring, the best-cell reduction, the
backtrace and cell-off storage, the SS table) and the K1/K6 sweep,
bit for bit against ``viterbi_batch`` / ``viterbi_score_lanes_plain``.
IEEE f32 on both sides (g++ -ffp-contract=off, as nvcc -fmad=false).
Skips where g++ is missing.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hhsuite_tpu_torch.device import CSRC_DIR
from hhsuite_tpu_torch.ops import viterbi as TV
from hhsuite_tpu_torch.ops import viterbi_lanes as VL
from hhsuite_tpu_torch.search.viterbi_search import to_device_pack
from test_torch_viterbi import make_inputs
from test_torch_viterbi_kernels import _ss_lut_inputs

EMU = os.path.join(os.path.dirname(__file__), "cuda_emu")


def emulated_source(src: str) -> str:
    """The CUDA source with its launches, dynamic shared memory and
    cp.async rewritten for the CPU stand-in."""
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = emu_dynamic_smem();")
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);",
                 lambda m: "emu_launch(%s, [&] { %s(%s); });"
                 % (m.group(2), m.group(1), m.group(3)), src, flags=re.S)
    src = re.sub(r"const unsigned d = \(unsigned\)__cvta_generic_to_shared"
                 r"\(dst\);\s*asm volatile\(.*?\);",
                 "*dst = src_bytes ? *static_cast<const float*>(src)"
                 " : 0.0f;", src, flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.(commit|wait)_group.*?\);', "",
                 src, flags=re.S)
    assert "asm" not in src and "<<<" not in src
    return src


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("cuda_emu")
    with open(os.path.join(CSRC_DIR, "viterbi.cu")) as f:
        (d / "viterbi_emu.cpp").write_text(emulated_source(f.read()))
    so = d / "libviterbi_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", EMU, "-o", str(so),
                    str(d / "viterbi_emu.cpp")], check=True,
                   capture_output=True, text=True)
    return VL.bind(ctypes.CDLL(str(so)))


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """The launch code of ops/viterbi_lanes.py on CPU tensors, into the
    emulated library."""
    monkeypatch.setattr(VL, "cuda_lib", lambda: emu_lib)
    monkeypatch.setattr(VL, "_require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(VL, "_stream", lambda dev: 0)


def _inputs(Lq, Lt, B, seed):
    qp, qtr, tp, ttr, t_L, co, _ss = make_inputs(Lq, Lt, B, seed=seed)
    tp_d, ttr_d, tl_d = to_device_pack(tp, ttr, t_L, "cpu")
    return (torch.from_numpy(qp), torch.from_numpy(qtr), tp_d, ttr_d, tl_d,
            torch.from_numpy(co))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# (Lq, Lt, B, G, local, cell-off, SS): one and two passes at each group
# width, blocks left partly empty, a template ring that wraps
BT_CASES = [(37, 29, 11, 8, True, False, False),
            (70, 21, 3, 8, True, True, False),
            (64, 49, 33, 8, True, False, True),
            (40, 23, 5, 16, False, True, True),
            (130, 40, 20, 16, True, True, True),
            (257, 20, 9, 32, False, False, True),
            (1, 9, 2, 32, True, True, False)]


@pytest.mark.parametrize("Lq,Lt,B,G,local,use_co,use_ss", BT_CASES)
def test_emulated_bt_kernel_bit_identical(emulated, monkeypatch, Lq, Lt, B,
                                          G, local, use_co, use_ss):
    geometry = VL.bt_geometry
    monkeypatch.setattr(VL, "bt_geometry",
                        lambda *a, **kw: geometry(*a, **kw, G=G))
    qp, qtr, tp, ttr, tl, co = _inputs(Lq, Lt, B, seed=Lq + G)
    co = co if use_co else None
    kw, tkw = {}, {}
    if use_ss:
        lut, qidx, tidx, _dense = (torch.from_numpy(x) for x in
                                   _ss_lut_inputs(Lq, Lt, B, seed=G))
        kw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
        tkw = VL.ss_table_args(lut, qidx, tidx, Lq, B, Lt, "cpu", "K3")
    got = VL.launch_bt(qp, qtr, tp, ttr, tl, co, -0.03, local,
                       max(1, Lq - 1), **tkw)
    want = TV.viterbi_batch(qp, qtr, tp, ttr, co, tl, -0.03, local=local,
                            Lq_true=max(1, Lq - 1), **kw)
    assert TV.bt_base(got[3]) is not None
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    kmax = Lq + Lt + 1
    assert torch.equal(
        TV.backtrace_walk_packed8(got[3], *got[1:3], got[0], kmax),
        TV.backtrace_walk_packed8(want[3], *want[1:3], want[0], kmax))


@pytest.mark.parametrize("mode", ["fast", "exact", "lut", "dense"])
def test_emulated_score_kernel_bit_identical(emulated, mode):
    Lq, Lt, B = 37, 29, 40
    qp, qtr, tp, ttr, tl, _co = _inputs(Lq, Lt, B, seed=3)
    lut, qidx, tidx, dense = (torch.from_numpy(x) for x in
                              _ss_lut_inputs(Lq, Lt, B, seed=4))
    kw, pkw = {}, {}
    if mode == "lut":
        kw = VL.ss_table_args(lut, qidx, tidx, Lq, B, Lt, "cpu", "K6")
        pkw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
    elif mode == "dense":
        kw = dict(ss=VL._lanes_last(dense, torch.float32))
        pkw = dict(ss_score=dense)
    fast = mode == "fast"
    sh = VL._fast_shift(-0.03) if fast else -0.03
    got = VL.launch_score(qp, qtr, tp, ttr, sh, fast, mode, **kw)
    want = VL.viterbi_score_lanes_plain(
        qp, qtr, tp, ttr, tl, -0.03, si_mode="fast" if fast else "exact",
        **pkw)
    assert torch.equal(_bits(got), _bits(want))


def test_emulated_bt_entry_refuses_other_geometries(emulated, monkeypatch):
    qp, qtr, tp, ttr, tl, _co = _inputs(20, 10, 3, seed=5)
    geometry = VL.bt_geometry
    monkeypatch.setattr(VL, "bt_geometry",
                        lambda *a, **kw: geometry(*a, **kw)._replace(G=4))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        VL.launch_bt(qp, qtr, tp, ttr, tl, None, -0.03, True, None)
