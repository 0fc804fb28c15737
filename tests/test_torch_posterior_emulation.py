"""``csrc/posterior.cu`` compiled with g++ against the CPU stand-in for
the CUDA runtime (``tests/cuda_emu/cuda_runtime.h``, as
``test_torch_cuda_emulation.py`` compiles ``csrc/viterbi.cu``) and run on
the CPU through the port's own launch code (``ops/posterior_batch.py``).

R1 (Forward rows), R2 (Backward rows and posteriors), R3 (MAC rows,
codes, argmax) and R4 (the packed walk) are held bit for bit (R4 byte
for byte) to their plain versions at ``chip_smoke.realign_edge_shapes``:
a row narrower than the CTA, a row that does not fill its last segment,
one query row, padding lanes, an empty walk, ragged ``t_L`` in global
mode, SS factors off, dense, and as a table (each SS mode, SS and
non-SS lanes in one chunk; R1 and R2 in both SS forms), 0-3 exclusion
bands, rows of 1-8 columns a thread (R1/R2 in registers, the profile
of 5 in shared memory), 9 (the wide kernels in shared memory) and 47
(their global scratch); and once with
every row array forced into the global scratch.  R3 is also held alone,
bit for bit, at planted posteriors (``MAC_CASES``): rows of 1-9 columns
a thread, ragged ``t_L`` in global mode, tied maxima, a lane with no
open cell.  R4 is also held alone, byte for byte, at planted walks
(``chip_smoke.mac_walk_edge_cases``): diagonals and runs of MI or IM
across tile borders, row 1 and column 1 on and off a tile's edge, STOP
and unused codes inside tiles, corner and non-MM starts, a short kmax
and kmax = 1, a plane smaller than a tile, random codes; with its
refusals and the marks where the ablation tool edits it.  Skips where
g++ is missing.
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import (REALIGN_MACT, REALIGN_SHIFT, mac_walk_check,
                        mac_walk_edge_cases, mac_walk_inputs, mac_walk_side,
                        realign_edge_shapes, realign_inputs)
from hhsuite_tpu_torch.device import CSRC_DIR
from hhsuite_tpu_torch.ops import posterior_batch as PB
from test_torch_cuda_emulation import build_emulated


@pytest.fixture(scope="module")
def post_emu_lib(tmp_path_factory):
    return PB.bind(build_emulated("posterior", tmp_path_factory))


@pytest.fixture
def post_emulated(post_emu_lib, monkeypatch):
    """The launch code of ops/posterior_batch.py on CPU tensors, into the
    emulated library."""
    monkeypatch.setattr(PB, "cuda_lib", lambda: post_emu_lib)
    monkeypatch.setattr(PB, "_require_cuda", lambda x: x.device)
    monkeypatch.setattr(PB, "_stream", lambda dev: 0)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


CASES = realign_edge_shapes() + [
    ("row arrays in the global scratch", 6, 1100, 2, 1, True, True, "pad")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_emulated_realign_kernels_bit_identical(post_emulated, monkeypatch,
                                                case):
    tag, Lq, Lt_pad, B, P, ss, local, extras = case
    if "scratch" in tag:
        monkeypatch.setattr(PB, "SMEM_MAX", 0)
    x = realign_inputs(Lq, Lt_pad, B, P, ss, seed=Lq + Lt_pad, device="cpu",
                       extras=extras)
    cs = float(np.exp2(np.float32(REALIGN_SHIFT)))
    args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], cs)
    n0 = [f.launches for f in (PB.fb_forward, PB.fb_backward, PB.mac_dp,
                               PB.mac_walk_packed8)]

    # the SS forms: dense (or none), and the table where there is one
    forms = [(x["ss_f"], None)]
    if x["ss_table"] is not None:
        forms.append((None, x["ss_table"]))
    fwd, scales, pfwd = PB.fb_forward_plain(*args, x["ss_f"], x["ss0"],
                                            local, x["t_L"])
    for ss_f, table in forms:
        got = PB._launch_forward(*args, ss_f, x["ss0"], local, x["t_L"],
                                 table)
        for a, b in zip(got, (fwd, scales, pfwd)):
            assert _same(a, b)

    pmm = PB.fb_backward_plain(*args, fwd, scales, pfwd, x["ss_f"], local,
                               x["t_L"])
    for ss_f, table in forms:
        assert _same(PB._launch_backward(*args, fwd, scales, pfwd, ss_f,
                                         local, x["t_L"], table), pmm)
    assert torch.isfinite(pmm).all()

    bmac, i2, j2 = PB.mac_dp_plain(pmm, x["co"], REALIGN_MACT, local,
                                   x["t_L"])
    got = PB._launch_mac(pmm, x["co"], REALIGN_MACT, local, x["t_L"])
    for a, b in zip(got, (bmac, i2, j2)):
        assert torch.equal(a, b)

    score = torch.from_numpy(PB.forward_score(scales, pfwd, Lq, Lt_pad,
                                              local))
    want = PB.mac_walk_packed8_plain(bmac, pmm, i2, j2, score, x["kmax"])
    assert torch.equal(PB._launch_walk(bmac, pmm, i2, j2, score, x["kmax"]),
                       want)
    n = PB.mac_walk_unpack8(want.numpy(), x["kmax"])[3]
    if "pad" in extras:
        # a padding lane: no open cell, no walk, and (local) a finite score
        assert n[-1] == 0 and (i2[-1], j2[-1]) == (0, 0)
        assert not local or bool(torch.isfinite(score[-1]))
    if "empty" in extras:
        assert i2[1] == 1 and n[1] == 0
    nf = len(forms)
    assert [f.launches for f in (PB.fb_forward, PB.fb_backward, PB.mac_dp,
                                 PB.mac_walk_packed8)] == [
        n0[0] + nf, n0[1] + nf, n0[2] + 1, n0[3] + 1]


# R3 alone on planted posteriors: rows of c = 1..8 columns a thread (the
# register kernel, the last segment partly padding) and c = 9 (the wide
# kernel), local and global with ragged t_L; two cells of one maximum
# (in one thread's segment, in two threads', in two rows: the first in
# row-major order wins); a lane with no open cell
MAC_CASES = ([(f"c{c}", 5, 128 * c - 5, 3, c % 2 == 1, "random")
              for c in range(1, 10)]
             + [("global, ragged t_L", 9, 300, 4, False, "random"),
                ("equal maxima", 14, 600, 4, True, "ties"),
                ("equal maxima, global", 14, 260, 2, False, "ties"),
                ("no open cell", 6, 200, 3, True, "closed")])


def mac_dp_case(Lq, Lt_pad, B, local, pattern, device="cpu"):
    """R3's inputs on ``device``: p_mm (B, Lq+1, Lt_pad+1) f32, co bool,
    t_L (B,) int32 (None in local mode).  ``random``: uniform posteriors,
    30% of the cells off; ``ties``: zero posteriors but four spikes of
    0.9 in row-major order, (2, 3) and (2, 5) in one segment, (3, 140)
    and (12, 4) in others, so S peaks at 0.9 - mact in each (a gap
    costs mact / 2 a cell, so no spike lifts another; global mode:
    spikes in row Lq and in row 1 at each lane's last column); ``closed``:
    as random, lane 1 with every cell off."""
    rng = np.random.default_rng(Lq * 1000 + Lt_pad)
    Wj = Lt_pad + 1
    p = rng.random((B, Lq + 1, Wj)).astype(np.float32)
    co = rng.random((B, Lq + 1, Wj)) < 0.3
    t_L = rng.integers(Wj // 2, Wj, B).astype(np.int32)
    if pattern == "ties":
        p[:] = 0.0
        co[:] = False
        spikes = ([(2, 3), (2, 5), (3, 140), (12, 4)] if local else
                  [(Lq, 7), (Lq, 9)])
        for i, j in spikes:
            p[:, i, j] = 0.9
        if not local:
            p[np.arange(B), 1, t_L] = 0.9
    if pattern == "closed":
        co[1] = True
    x = dict(p_mm=torch.from_numpy(p).to(device),
             co=torch.from_numpy(co).to(device),
             t_L=None if local else torch.from_numpy(t_L).to(device))
    return x


def check_mac_dp(got, x, local, pattern):
    want = PB.mac_dp_plain(x["p_mm"], x["co"], REALIGN_MACT, local,
                           x["t_L"])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    i2, j2 = want[1].cpu(), want[2].cpu()
    if pattern == "ties":
        if local:
            assert (i2 == 2).all() and (j2 == 3).all()
        else:
            assert (i2 == 1).all() and torch.equal(j2, x["t_L"].cpu())
    if pattern == "closed":
        assert (i2[1], j2[1]) == (0, 0) and (want[0][1, 1:].cpu() == 0).all()
    else:
        assert (i2 > 0).all()


@pytest.mark.parametrize("case", MAC_CASES, ids=lambda c: c[0])
def test_emulated_mac_dp_bit_identical(post_emulated, case):
    tag, Lq, Lt_pad, B, local, pattern = case
    x = mac_dp_case(Lq, Lt_pad, B, local, pattern)
    n0 = PB.mac_dp.launches
    got = PB._launch_mac(x["p_mm"], x["co"], REALIGN_MACT, local, x["t_L"])
    assert PB.mac_dp.launches == n0 + 1
    check_mac_dp(got, x, local, pattern)


# R4 alone on planted walks (chip_smoke.mac_walk_edge_cases)
WALK_EDGES = mac_walk_edge_cases()


def mac_walk_case(case, device="cpu"):
    """R4's inputs for one edge case, seeded by its place in the list."""
    return mac_walk_inputs(case, 70 + WALK_EDGES.index(case), device)


def check_mac_walk(got, x, case):
    """``got`` equals the plain walk byte for byte, with the planted
    step counts; a kmax shorter than the walks cuts most of them."""
    assert got.dtype == torch.int8 and mac_walk_check(got, x, case[0]) == 0
    n = PB.mac_walk_unpack8(got.cpu().numpy(), x["kmax"])[3]
    if case[4] is not None and case[4] < case[1]:
        assert (n == x["kmax"]).sum() >= 4


@pytest.mark.parametrize("case", WALK_EDGES, ids=lambda c: c[0])
def test_emulated_mac_walk_byte_identical(post_emulated, case):
    x = mac_walk_case(case)
    n0 = PB.mac_walk_packed8.launches
    got = PB._launch_walk(x["b_mac"], x["p_mm"], x["i2"], x["j2"],
                          x["score"], x["kmax"])
    assert PB.mac_walk_packed8.launches == n0 + 1
    check_mac_walk(got, x, case)


def test_emulated_mac_walk_refusals(post_emulated, post_emu_lib):
    x = mac_walk_case(WALK_EDGES[0])
    args = (x["b_mac"], x["p_mm"], x["i2"], x["j2"], x["score"])
    with pytest.raises(ValueError, match="kmax"):
        PB._launch_walk(*args, 0)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        PB._launch_walk(*(a[:, :, :1] if a.dim() == 3 else a
                          for a in args), 10)      # Wj = 1
    # a plane of more than INT_MAX cells, a negative batch
    for B, Lq, Wj in ((1, 1 << 16, 1 << 15), (-1, 10, 10)):
        assert post_emu_lib.hh_post_walk(None, None, None, None, None, B, Lq,
                                         Wj, 10, None, None) != 0


def test_walk_mac_ablation_edits_the_walk_at_its_marks():
    # tools/walk_mac_ablation.py's R4 variants edit mac_walk_kernel at its
    # "// ablation:" marks (and its signature, launch and __syncwarp for
    # teams): each mark is there once, and each variant changes the source
    from hhsuite_tpu_torch.tools import walk_mac_ablation as W

    with open(os.path.join(CSRC_DIR, "posterior.cu")) as f:
        post = f.read()
    with open(os.path.join(CSRC_DIR, "viterbi.cu")) as f:
        vit = f.read()
    for name in ("lanes", "walker", "gather", "row", "post_store", "codes",
                 "posts", "tail", "record"):
        assert len(re.findall(rf"// ablation:{name}$", post, re.M)) == 1
    side = mac_walk_side(post)
    out = W.variants(vit, post)
    r4 = {k: src for k, (lib, src) in out.items() if k.startswith("R4_")}
    assert r4[f"R4_R{side}_G32"] == post
    assert all(src != post for k, src in r4.items()
               if k != f"R4_R{side}_G32")
    teams = r4[f"R4_R{side}_G16"]
    assert "__syncwarp()" not in teams.split(" mac_walk_kernel(")[1]
    assert f"mac_walk_kernel<<<(B + 1) / 2, 32," in teams
