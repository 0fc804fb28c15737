"""``csrc/viterbi.cu`` compiled with g++ against a CPU stand-in for the
CUDA runtime (``tests/cuda_emu/cuda_runtime.h``: threads, block
barriers, warp shuffles) and run on the CPU through the port's own
launch code (``ops/viterbi_lanes.py:launch_bt`` and ``launch_score``).

The card is where the kernels are held to their plain versions
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this runs the same
source's control flow here: the K2/K3 wavefront (group widths, passes,
the pass boundary, the template ring, the best-cell reduction, the
backtrace and cell-off storage, the SS table) and the K1/K6 sweep on
the same wavefront (fast, exact, SS table and dense SS at each group
width, across the pass boundary), bit for bit against ``viterbi_batch``
/ ``viterbi_score_lanes_plain``; and the walk W1 (``launch_walk``) byte
for byte against ``backtrace_walk_packed8_plain`` on K2/K3's storage
view and on contiguous bytes, at every shape of
``chip_smoke.bt_edge_shapes``, with a lane of padding, planted codes 1
and 7 and a kmax shorter than the paths, and at planted walks that cross
many tiles (``WALK_TILE_CASES``).
IEEE f32 on both sides (g++ -ffp-contract=off, as nvcc -fmad=false).
Skips where g++ is missing.
"""

import ctypes
import functools
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
from chip_smoke import bt_edge_shapes
from test_torch_viterbi import make_inputs
from test_torch_viterbi_kernels import _ss_lut_inputs

EMU = os.path.join(os.path.dirname(__file__), "cuda_emu")


def emulated_source(src: str) -> str:
    """The CUDA source with its launches, dynamic shared memory and
    cp.async rewritten for the CPU stand-in."""
    src = re.sub(r"extern __shared__ __align__\(16\) (\w+) smem\[\];",
                 r"\1* smem = reinterpret_cast<\1*>(emu_dynamic_smem());",
                 src)
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


def build_emulated(name: str, tmp_path_factory) -> ctypes.CDLL:
    """``csrc/<name>.cu`` compiled with g++ against the stand-in and
    loaded (skips where g++ is missing)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("cuda_emu")
    with open(os.path.join(CSRC_DIR, name + ".cu")) as f:
        (d / f"{name}_emu.cpp").write_text(emulated_source(f.read()))
    so = d / f"lib{name}_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", EMU, "-o", str(so),
                    str(d / f"{name}_emu.cpp")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return VL.bind(build_emulated("viterbi", tmp_path_factory))


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


# (G, Lq, Lt, B, padded lane): the first at the width score_geometry
# picks; then at each group width one query row, one pass exactly (G*8
# rows), a second pass of one row (G*8 + 1), three passes (2*G*8 + 1),
# one template column, fewer columns than lanes, one template, and a
# block of 256/G templates left partly empty, its last lane padding only
SCORE_CASES = [(None, 37, 29, 40, False)] + [
    c for G in (8, 16, 32) for c in (
        (G, 1, 13, 5, False), (G, 8 * G, 11, 3, True),
        (G, 8 * G + 1, 9, 4, False), (G, 16 * G + 1, 7, 2, False),
        (G, 20, 1, 6, False), (G, 24, G - 3, 3, False),
        (G, 30, 10, 1, False), (G, 17, 6, 256 // G + 3, True))]


def _score_case_id(mode, case):
    G, Lq, Lt, B, pad = case
    return mode if G is None else (f"{mode}-G{G}-Lq{Lq}-Lt{Lt}-B{B}"
                                   + ("-pad" if pad else ""))


@pytest.mark.parametrize("mode,case", [
    pytest.param(m, c, id=_score_case_id(m, c)) for c in SCORE_CASES
    for m in ("fast", "exact", "lut", "dense")])
def test_emulated_score_kernel_bit_identical(emulated, monkeypatch, mode,
                                             case):
    G, Lq, Lt, B, pad = case
    geometry = VL.score_geometry
    monkeypatch.setattr(VL, "score_geometry",
                        lambda *a, **kw: geometry(*a, **kw, G=G))
    qp, qtr, tp, ttr, t_L, _co, ss = make_inputs(Lq, Lt, B, seed=Lq + Lt)
    if pad:        # a lane of padding only, as pack_templates pads a batch
        tp[-1], ttr[-1] = 0.0, -TV.FLT_MAX
    tp, ttr, tl = to_device_pack(tp, ttr, t_L, "cpu")
    qp, qtr = torch.from_numpy(qp), torch.from_numpy(qtr)
    kw, pkw = {}, {}
    if mode == "lut":
        lut, qidx, tidx, _dense = (torch.from_numpy(x) for x in
                                   _ss_lut_inputs(Lq, Lt, B, seed=B))
        kw = VL.ss_table_args(lut, qidx, tidx, Lq, B, Lt, "cpu", "K6")
        pkw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
    elif mode == "dense":
        kw = dict(ss=torch.from_numpy(ss))
        pkw = dict(ss_score=kw["ss"])
    fast = mode == "fast"
    sh = VL._fast_shift(-0.03) if fast else -0.03
    got = VL.launch_score(qp, qtr, tp, ttr, sh, fast, mode, **kw)
    want = VL.viterbi_score_lanes_plain(
        qp, qtr, tp, ttr, tl, -0.03, si_mode="fast" if fast else "exact",
        **pkw)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isfinite(got).all()


def test_emulated_bt_entry_refuses_other_geometries(emulated, monkeypatch):
    qp, qtr, tp, ttr, tl, _co = _inputs(20, 10, 3, seed=5)
    geometry = VL.bt_geometry
    monkeypatch.setattr(VL, "bt_geometry",
                        lambda *a, **kw: geometry(*a, **kw)._replace(G=4))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        VL.launch_bt(qp, qtr, tp, ttr, tl, None, -0.03, True, None)


# ------------------------------------------------------------------ W1 --

# every (Lq, Lt, B) of the K2/K3 wavefront edges (the walk has no group
# width): on K2/K3's storage view and on contiguous bytes, the last lane
# padding (i2 = j2 = 0); on three of them also planted codes 1 and 7
# and a kmax of 5
WALK_SHAPES = sorted({(Lq, Lt, B) for _G, Lq, Lt, B in bt_edge_shapes()})
WALK_CASES = [(*shape, layout, "pad") for shape in WALK_SHAPES
              for layout in ("storage", "contiguous")] + [
    (*shape, layout, variant) for shape in WALK_SHAPES[-3:]
    for variant in ("codes", "short") for layout in ("storage", "contiguous")]


def _walk_case_id(case):
    Lq, Lt, B, layout, variant = case
    return f"Lq{Lq}-Lt{Lt}-B{B}-{layout}-{variant}"


@functools.lru_cache(maxsize=None)
def _walk_dp(Lq, Lt, B):
    """The plain Viterbi on seeded profiles, local when Lq is even, else
    global: (score, i2, j2, bt contiguous), CPU tensors."""
    qp, qtr, tp, ttr, tl, _co = _inputs(Lq, Lt, B, seed=Lq + Lt + B)
    return TV.viterbi_batch(qp, qtr, tp, ttr, None, tl, -0.03,
                            local=Lq % 2 == 0)


def walk_case(Lq, Lt, B, layout, variant, device="cpu"):
    """W1's inputs for one :data:`WALK_CASES` entry on ``device``: (bt in
    ``layout``, i2, j2, score, kmax), and the contiguous bt on the CPU.
    ``pad``: the last lane (of several) has i2 = j2 = 0; ``codes``: 5% of
    the bytes carry the unused codes 1 or 7 in bits 0-2; ``short``: kmax
    = 5, shorter than most paths."""
    score, i2, j2, bt = _walk_dp(Lq, Lt, B)
    i2, j2 = i2.clone(), j2.clone()
    kmax = 5 if variant == "short" else Lq + Lt + 1
    if variant == "pad" and B > 1:
        i2[-1] = j2[-1] = 0
    if variant == "codes":
        rng = np.random.default_rng(Lq)
        b = bt.numpy().copy()
        hit = rng.random(b.shape) < 0.05
        b[hit] = (b[hit] & 0xF8) | rng.choice([1, 7], int(hit.sum()))
        bt = torch.from_numpy(b)
    if layout == "storage":
        store, dev_bt = TV.bt_storage(B, Lq, Lt, torch.uint8, device)
        store.fill_(0xAB)           # bytes outside the view never matter
        dev_bt.copy_(bt)
    else:
        dev_bt = bt.to(device)
    return ((dev_bt, i2.to(device), j2.to(device), score.to(device), kmax),
            bt)


def check_walk_payload(got, case, bt, i2, j2, score, kmax):
    """``got`` equals the plain walk byte for byte, and the case shows
    what it plants."""
    want = TV.backtrace_walk_packed8_plain(bt, i2.cpu(), j2.cpu(),
                                           score.cpu(), kmax)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    n = want[:, 8:12].numpy().copy().view(np.int32)[:, 0]
    st = want[:, 12:].numpy()
    Lq, Lt, B, _layout, variant = case
    if variant == "pad" and B > 1:
        assert int(n[-1]) == 1 and int(st[-1, 0]) == TV.MM
    if variant == "codes":
        assert ((st == 1) | (st == 7)).any()
    if variant == "short":
        assert (n == kmax).any()
    assert int(n.max()) > 1 or Lq == 1 or Lt == 1


@pytest.mark.parametrize("case", WALK_CASES, ids=_walk_case_id)
def test_emulated_walk_byte_identical(emulated, case):
    args, bt = walk_case(*case)
    if case[3] == "storage":
        assert TV.bt_base(args[0]) is not None
    n0 = TV.backtrace_walk_packed8.launches
    got = TV.launch_walk(*args)
    assert TV.backtrace_walk_packed8.launches == n0 + 1
    check_walk_payload(got, case, bt, *args[1:])


def test_emulated_walk_refusals(emulated, emu_lib):
    """The C entry refuses B < 0, kmax < 1 and a null pointer; the
    wrapper raises RuntimeError for the entry's refusal and ValueError
    for a bt that is not uint8."""
    (bt, i2, j2, score, _kmax), _bt = walk_case(37, 29, 11, "contiguous",
                                                "pad")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        TV.launch_walk(bt, i2, j2, score, 0)
    with pytest.raises(ValueError, match="uint8"):
        TV.launch_walk(bt.to(torch.int8), i2, j2, score, 10)
    out = torch.empty((11, 22), dtype=torch.int8)
    ptrs = [x.data_ptr() for x in (bt, i2, j2, score)] + [out.data_ptr()]
    for k in range(len(ptrs)):
        bad = list(ptrs)
        bad[k] = None
        assert emu_lib.hh_vit_walk(bad[0], *bt.stride(), *bad[1:4], 11, 10,
                                   bad[4], None) != 0
    assert emu_lib.hh_vit_walk(*ptrs[:1], *bt.stride(), *ptrs[1:4], -1, 10,
                               ptrs[4], None) != 0
    assert emu_lib.hh_vit_walk(*ptrs[:1], *bt.stride(), *ptrs[1:4], 11, 0,
                               ptrs[4], None) != 0
    assert emu_lib.hh_vit_walk(*ptrs[:1], *bt.stride(), *ptrs[1:4], 11, 10,
                               ptrs[4], None) == 0


# W1's tiles: planted backtrace bytes whose walks cross many tiles, run
# along a diagonal, along a row or a column, along row 1 and column 1,
# or through random codes (also with a kmax shorter than the walks);
# B = 7 walks, not a multiple of the eight a block holds, the last one a
# padding lane; each on both layouts, through the search's entry
# (hh_vit_walk)
WALK_PATTERNS = ("diagonal", "gap-runs", "rows-1-and-columns-1", "random",
                 "random-short-kmax")
WALK_TILE_CASES = [(p, layout) for p in WALK_PATTERNS
                   for layout in ("storage", "contiguous")]


def _walk_tile_id(case):
    p, layout = case
    return f"{p}-{layout}-R{TV.WALK_R}-G{TV.WALK_G}-entry"


def walk_tile_case(pattern, layout, device="cpu"):
    """W1's inputs for one :data:`WALK_PATTERNS` entry on ``device``: (bt
    in ``layout``, i2, j2, score, kmax), and the contiguous bt on the
    CPU.  Lq = 150, Lt = 140, B = 7 (lane 6 padding: i2 = j2 = 0).
    ``diagonal``: every byte's MM code is MM; ``gap-runs``: MM opens GD
    (even lanes) or DG (odd lanes), never closed, so the walk runs along
    its row or column to column or row 1; ``rows-1-and-columns-1``:
    lanes start at row 2 (MM opens GD: a run along row 1), column 2 (MM
    opens DG: a run along column 1), at row 1 or at column 1 (blocked at
    once); ``random``: random MM codes of the five states and gap bits
(each set with p = 0.4), so the walks change state often and run to
row or column 1."""
    Lq, Lt, B = 150, 140, 7
    rng = np.random.default_rng(len(pattern))
    bt = np.full((B, Lq + 1, Lt + 1), TV.MM, np.uint8)
    i2 = np.array([Lq, Lq - 3, 120, 150, 37, 149, 0], np.int32)
    j2 = np.array([Lt, 139, 140, 17, 133, 90, 0], np.int32)
    kmax = Lq + Lt + 1
    if pattern == "gap-runs":
        bt[0::2] = TV.GD
        bt[1::2] = TV.DG
    elif pattern == "rows-1-and-columns-1":
        i2[:6] = [2, 90, 2, 1, 77, 1]
        j2[:6] = [130, 2, 64, 100, 2, 1]
        for b in range(6):
            bt[b] = TV.GD if i2[b] == 2 else TV.DG
    elif pattern.startswith("random"):
        gaps = rng.random(bt.shape + (4,)) < 0.4
        bt = (rng.integers(TV.MM, TV.MI + 1, bt.shape)
              | (gaps * np.array([8, 16, 32, 64])).sum(-1)).astype(np.uint8)
        if pattern == "random-short-kmax":
            kmax = 40
    bt_c = torch.from_numpy(bt)
    score = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    if layout == "storage":
        store, dev_bt = TV.bt_storage(B, Lq, Lt, torch.uint8, device)
        store.fill_(0xAB)           # bytes outside the view never matter
        dev_bt.copy_(bt_c)
    else:
        dev_bt = bt_c.to(device)
    i2, j2 = torch.from_numpy(i2), torch.from_numpy(j2)
    return ((dev_bt, i2.to(device), j2.to(device), score.to(device), kmax),
            bt_c)


def check_walk_tile_payload(got, pattern, bt, i2, j2, score, kmax):
    """``got`` equals the plain walk byte for byte, and the pattern's
    walks are what it plants."""
    want = TV.backtrace_walk_packed8_plain(bt, i2.cpu(), j2.cpu(),
                                           score.cpu(), kmax)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    n = want[:, 8:12].numpy().copy().view(np.int32)[:, 0]
    st = want[:, 12:].numpy()
    assert n[-1] == 1                 # the padding lane: blocked at once
    if pattern == "diagonal":         # to row or column 1, plus the stop
        want_n = np.minimum(i2.cpu().numpy(), j2.cpu().numpy())[:-1]
        assert (n[:-1] == want_n).all()
    if pattern == "gap-runs":         # one MM step, then the run
        assert (st[0::2, 1][:3] == TV.GD).all() and n.max() > 128
        assert (st[1::2, 1][:3] == TV.DG).all()
    if pattern == "rows-1-and-columns-1":
        assert list(n[:6]) == [130, 90, 64, 1, 77, 1]
    if pattern == "random":
        assert n.max() > 128 and n[:-1].min() > 16
    if pattern == "random-short-kmax":
        assert (n == kmax).sum() >= 4


@pytest.mark.parametrize("case", WALK_TILE_CASES, ids=_walk_tile_id)
def test_emulated_walk_tiles_byte_identical(emulated, case):
    pattern, layout = case
    args, bt = walk_tile_case(pattern, layout)
    if layout == "storage":
        assert TV.bt_base(args[0]) is not None
    n0 = TV.backtrace_walk_packed8.launches
    got = TV.launch_walk(*args)
    assert TV.backtrace_walk_packed8.launches == n0 + 1
    check_walk_tile_payload(got, pattern, bt, *args[1:])


def test_walk_tile_constants_match_the_source():
    # ops/viterbi.py's WALK_R / WALK_G (the model and the reports) are
    # the ones csrc/viterbi.cu builds W1 with
    with open(os.path.join(CSRC_DIR, "viterbi.cu")) as f:
        src = f.read()
    for name, value in (("WALK_R", TV.WALK_R), ("WALK_G", TV.WALK_G)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value
