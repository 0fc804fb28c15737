"""The launch geometry of the prefilter kernels (K4 and K5, one
wavefront body; ``ops/prefilter.py:pf_geometry``), by which the kernel
(``csrc/prefilter.cu``) maps query rows: G lanes a database sequence, R =
8 rows a lane, passes of G*R rows, 256 threads a block.  Every query row
goes to exactly one (pass, lane, row), G follows the cost model at the
hhblits path's shapes, the passes, table pitch and scratch size the C
entries report (compiled for the CPU as in
``test_torch_prefilter_emulation.py``) agree with it, and ``hh_pf_gapped``
and ``hh_pf_ungapped`` refuse any other width and any argument they
cannot run.
"""

import pytest
import torch

from hhsuite_tpu_torch.ops import prefilter as P
from test_torch_prefilter import make_inputs
from test_torch_prefilter_emulation import pf_emu_lib  # noqa: F401
from test_torch_prefilter_emulation import pf_emulated  # noqa: F401

INVALID = 1          # cudaErrorInvalidValue


def _rows(geo, Lq):
    rows = [geo.row(p, k, r) - 1 for p in range(geo.passes)
            for k in range(geo.G) for r in range(geo.R)]
    return [i for i in rows if i < Lq], [i for i in rows if i >= Lq]


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 128, 129, 256, 257, 300,
                                1025])
def test_every_row_once_at_each_width(G, Lq):
    geo = P.pf_geometry(40, Lq, 300, G=G)
    assert (geo.G, geo.R) == (G, 8)
    assert geo.groups * geo.G == 256
    assert geo.passes == -(-Lq // (G * geo.R))
    real, past = _rows(geo, Lq)
    assert sorted(real) == list(range(Lq))
    # rows past Lq only fill the last pass
    assert all(i >= (geo.passes - 1) * G * geo.R for i in past)


def test_widths_at_the_path_shapes():
    """Lq = 300 (the hhblits query): G = 8 at phase 1's 65,536 sequences
    and at the 2^20 query's stage-2 batches (30,615 and 20,181
    survivors), 16 at 2,048, 32 where a few sequences leave most of the
    card idle."""
    for B in (65536, 30615, 20181):
        geo = P.pf_geometry(B, 300, 300)
        assert (geo.G, geo.passes) == (8, 5)
    assert P.pf_geometry(2048, 300, 300).G == 16
    assert P.pf_geometry(40, 300, 300).G == 32
    # all sequences empty: the fill and drain steps decide, G = 8
    assert P.pf_geometry(40, 300, 0).G == 8


def test_geometry_refuses_what_the_kernel_does_not_take():
    for B, Lq in ((0, 10), (4, 0)):
        with pytest.raises(ValueError):
            P.pf_geometry(B, Lq, 50)
    for G in (4, 64):
        with pytest.raises(ValueError):
            P.pf_geometry(4, 10, 50, G=G)


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("Lq", [1, 64, 65, 300, 1024, 1025, 2000])
def test_entry_reports_the_geometry(pf_emu_lib, G, Lq):  # noqa: F811
    """Passes, table pitch and scratch bytes from the compiled source."""
    geo = P.pf_geometry(100, Lq, 300, G=G)
    lib = pf_emu_lib
    assert lib.hh_pf_passes(Lq, G) == geo.passes
    assert lib.hh_pf_pitch(Lq) == -(-Lq // geo.R) * geo.R
    n = 3 * 10 ** 9                     # past 2^31: the 2^20 pack x 10
    assert lib.hh_pf_scratch_bytes(Lq, G, n) == (
        2 * n if geo.passes > 1 else 0)


@pytest.mark.parametrize("G", [0, 4, 12, 64])
def test_entry_refuses_other_widths(pf_emulated, monkeypatch,  # noqa: F811
                                    G):
    qc, db, dl = (torch.from_numpy(x) for x in make_inputs(20, 10, 3, 5))
    geometry = P.pf_geometry
    monkeypatch.setattr(P, "pf_geometry",
                        lambda *a, **kw: geometry(*a, **kw)._replace(G=G))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        P._launch_gapped(qc, *P._as_packed(db, dl), 24, 4, 50)
    assert P.cuda_lib().hh_pf_passes(20, G) == -1
    assert P.cuda_lib().hh_pf_scratch_bytes(20, G, 30) == -1


def test_entry_refuses_what_it_cannot_run(pf_emu_lib):  # noqa: F811
    """hh_pf_gapped's own checks, before it touches any pointer: several
    passes with no scratch row, a negative gap or offset, an empty
    query; nothing to launch for no sequence."""
    f = pf_emu_lib.hh_pf_gapped
    p = torch.zeros(4).data_ptr()

    def call(Lq=20, G=8, gi=24, ge=4, off=50, scratch=None, B=3):
        return f(p, Lq, p, p, p, B, gi, ge, off, G, scratch, p, None)

    assert call(Lq=65, G=8) == INVALID            # 2 passes, no scratch
    assert call(Lq=257, G=32) == INVALID
    assert call(Lq=0) == INVALID
    assert call(gi=-1) == INVALID
    assert call(ge=-1) == INVALID
    assert call(off=-1) == INVALID
    assert call(B=0) == 0                         # nothing to launch


def test_geometry_names_the_kernel():
    with pytest.raises(ValueError, match="K4 ungapped_scores"):
        P.pf_geometry(4, 10, 50, G=12, what="K4 ungapped_scores")


@pytest.mark.parametrize("G", [0, 4, 12, 64])
def test_k4_entry_refuses_other_widths(pf_emulated, monkeypatch,  # noqa: F811
                                       G):
    qc, db, dl = (torch.from_numpy(x) for x in make_inputs(20, 10, 3, 5))
    geometry = P.pf_geometry
    monkeypatch.setattr(P, "pf_geometry",
                        lambda *a, **kw: geometry(*a, **kw)._replace(G=G))
    with pytest.raises(RuntimeError, match="K4 ungapped_scores: CUDA launch"):
        P._launch_ungapped(qc, *P._as_packed(db, dl), 50)


def test_k4_entry_refuses_what_it_cannot_run(pf_emu_lib):  # noqa: F811
    """hh_pf_ungapped's own checks, before it touches any pointer: a
    width other than 8, 16 or 32, an empty query, several passes with no
    scratch row, a negative offset; nothing to launch for no sequence."""
    f = pf_emu_lib.hh_pf_ungapped
    p = torch.zeros(4).data_ptr()

    def call(Lq=20, G=8, off=50, scratch=None, B=3):
        return f(p, Lq, p, p, p, B, off, G, scratch, p, None)

    for G in (0, 4, 12, 64):
        assert call(G=G) == INVALID
    assert call(Lq=0) == INVALID
    assert call(Lq=-3) == INVALID
    assert call(Lq=65, G=8) == INVALID            # 2 passes, no scratch
    assert call(Lq=257, G=32) == INVALID
    assert call(off=-1) == INVALID
    assert call(B=0) == 0                         # nothing to launch


def test_k4_wrapper_refuses_a_negative_offset(pf_emulated):  # noqa: F811
    """S past 255 would not fit the pass boundary's byte: the wrapper
    refuses before the entry is called."""
    qc, db, dl = (torch.from_numpy(x) for x in make_inputs(20, 10, 3, 5))
    with pytest.raises(ValueError, match="K4 ungapped_scores"):
        P._launch_ungapped(qc, *P._as_packed(db, dl), -1)


@pytest.mark.parametrize("stage", ["K4", "K5"])
def test_plain_versions_refuse_a_negative_setting(stage):
    """The CPU path refuses what the card's refuses: a negative offset
    (K4) or gap (K5)."""
    qc, db, dl = (torch.from_numpy(x) for x in make_inputs(20, 10, 3, 5))
    with pytest.raises(ValueError, match=stage):
        if stage == "K4":
            P.ungapped_scores(qc, db, dl, -1)
        else:
            P.gapped_scores(qc, db, dl, 24, -1, 50)
