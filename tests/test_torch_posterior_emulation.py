"""``csrc/posterior.cu`` compiled with g++ against the CPU stand-in for
the CUDA runtime (``tests/cuda_emu/cuda_runtime.h``, as
``test_torch_cuda_emulation.py`` compiles ``csrc/viterbi.cu``) and run on
the CPU through the port's own launch code (``ops/posterior_batch.py``).

R1 (Forward rows), R2 (Backward rows and posteriors), R3 (MAC rows,
codes, argmax) and R4 (the packed walk) are held bit for bit (R4 byte
for byte) to their plain versions at ``chip_smoke.realign_edge_shapes``:
a row narrower than the CTA, a row that does not fill its last segment,
one query row, padding lanes, an empty walk, ragged ``t_L`` in global
mode, SS factors on and off, 0-3 exclusion bands; and once with the row
arrays in the global scratch instead of shared memory.  Skips where g++
is missing.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (REALIGN_MACT, REALIGN_SHIFT, realign_edge_shapes,
                        realign_inputs)
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
    ("row arrays in the global scratch", 6, 150, 2, 1, True, True, "pad")]


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

    fwd, scales, pfwd = PB.fb_forward_plain(*args, x["ss_f"], x["ss0"],
                                            local, x["t_L"])
    got = PB._launch_forward(*args, x["ss_f"], x["ss0"], local, x["t_L"])
    for a, b in zip(got, (fwd, scales, pfwd)):
        assert _same(a, b)

    pmm = PB.fb_backward_plain(*args, fwd, scales, pfwd, x["ss_f"], local,
                               x["t_L"])
    assert _same(PB._launch_backward(*args, fwd, scales, pfwd, x["ss_f"],
                                     local, x["t_L"]), pmm)
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
    assert [f.launches for f in (PB.fb_forward, PB.fb_backward, PB.mac_dp,
                                 PB.mac_walk_packed8)] == [k + 1 for k in n0]
