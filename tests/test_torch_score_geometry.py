"""The launch geometry of the score-sweep Viterbi kernel (K1/K6,
``ops/viterbi_lanes.py:score_geometry``), by which the kernel
(``csrc/viterbi.cu``) maps rows: G lanes a template, R = 8 rows a lane,
passes of G*R rows, 256 threads a block.  Every query row goes to
exactly one (pass, lane, row) at every batch the funnel sweep sends (1
to 8192 templates), the choice of G follows the widths timed on the
H100 (``chip_smoke.py`` phase 1, PERF.md), and the C entry
``hh_vit_score``, compiled for the CPU as in
``test_torch_cuda_emulation.py``, takes G alone and refuses any other
width and any argument it cannot run.
"""

import pytest
import torch

from hhsuite_tpu_torch.ops import viterbi_lanes as VL
from test_torch_cuda_emulation import _inputs, emu_lib  # noqa: F401
from test_torch_cuda_emulation import emulated  # noqa: F401 (fixture)

INVALID = 1          # cudaErrorInvalidValue


def _rows(geo, Lq):
    rows = [geo.row(p, k, r) for p in range(geo.passes)
            for k in range(geo.G) for r in range(geo.R)]
    return [i for i in rows if i <= Lq], [i for i in rows if i > Lq]


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 128, 129, 256, 257, 513])
def test_every_row_once_at_each_width(G, Lq):
    geo = VL.score_geometry(37, Lq, 90, G=G)
    assert (geo.G, geo.R) == (G, 8)
    assert geo.groups * geo.G == VL.BT_THREADS == 256
    assert geo.passes == -(-Lq // (G * geo.R))
    real, past = _rows(geo, Lq)
    assert sorted(real) == list(range(1, Lq + 1))
    # rows past Lq only fill the last pass
    assert all(i > (geo.passes - 1) * G * geo.R for i in past)


@pytest.mark.parametrize("Lq", [1, 50, 320, 512])
@pytest.mark.parametrize("B", [1, 7, 64, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("Lt", [1, 128, 384, 768])
def test_chosen_geometry_is_valid(B, Lq, Lt):
    geo = VL.score_geometry(B, Lq, Lt)
    assert geo.G in (8, 16, 32)
    real, _past = _rows(geo, Lq)
    assert sorted(real) == list(range(1, Lq + 1))


def test_widths_at_the_sweep_shapes():
    """The fastest widths timed in chip_smoke.py phase 1 at Lq = 320, Lt =
    384 (PERF.md): 8 at a full SWEEP_BATCH chunk of 8192 templates, 16 at
    a partial one of 2048; and the widest group where a small batch
    leaves most of the card idle."""
    assert VL.score_geometry(8192, 320, 384).G == 8
    assert VL.score_geometry(2048, 320, 384).G == 16
    assert VL.score_geometry(64, 320, 384).G == 32


def test_geometry_refuses_what_the_kernel_does_not_take():
    for B, Lq, Lt in ((0, 10, 10), (4, 0, 10), (4, 10, 0)):
        with pytest.raises(ValueError):
            VL.score_geometry(B, Lq, Lt)
    for G in (4, 64):
        with pytest.raises(ValueError):
            VL.score_geometry(4, 10, 10, G=G)


@pytest.mark.parametrize("G", [0, 4, 12, 64])
def test_entry_refuses_other_widths(emulated, monkeypatch, G):  # noqa: F811
    qp, qtr, tp, ttr, _tl, _co = _inputs(20, 10, 3, seed=5)
    geometry = VL.score_geometry
    monkeypatch.setattr(VL, "score_geometry",
                        lambda *a, **kw: geometry(*a, **kw)._replace(G=G))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        VL.launch_score(qp, qtr, tp, ttr, -0.03, False, "K1")


def test_entry_refuses_what_it_cannot_run(emu_lib):  # noqa: F811
    """hh_vit_score's own checks, before it touches any pointer: several
    passes with no scratch row, the fast log2 with an SS term, both SS
    forms at once, a table larger than shared memory holds, an empty
    query or template."""
    f = emu_lib.hh_vit_score
    p = torch.zeros(4).data_ptr()

    def call(ss=None, lut=None, n_lut=0, Lq=20, Lt=10, fast=0, G=8,
             scratch=None, B=3):
        return f(p, p, p, p, ss, lut, n_lut, p if lut else None,
                 p if lut else None, B, Lq, Lt, -0.03, fast, G, scratch, p,
                 None)

    assert call(Lq=65, G=8) == INVALID            # 2 passes, no scratch
    assert call(Lq=257, G=32) == INVALID
    assert call(lut=p, n_lut=1936, fast=1) == INVALID
    assert call(ss=p, fast=1) == INVALID
    assert call(ss=p, lut=p, n_lut=10) == INVALID
    assert call(lut=p, n_lut=1937) == INVALID
    assert call(lut=p, n_lut=0) == INVALID
    assert call(Lq=0) == INVALID
    assert call(Lt=0) == INVALID
    assert call(G=4) == INVALID
    assert call(B=0) == 0                         # nothing to launch
