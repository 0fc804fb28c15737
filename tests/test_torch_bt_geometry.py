"""The launch geometry of the backtrace Viterbi kernel (K2/K3,
``ops/viterbi_lanes.py:bt_geometry``), by which the kernel
(``csrc/viterbi.cu``) maps rows: G lanes a template, R = 8 rows a lane,
passes of G*R rows, 256 threads a block.  Every query row goes to
exactly one (pass, lane, row), and the choice of G follows the cost
model at the search's batch shapes.  The kernel's shared-memory layout
is read from the source itself (``hh_bt_smem_bytes``,
``hh_bt_col_stride``), compiled for the CPU as in
``test_torch_cuda_emulation.py``: it stays within what a block may take
and free of bank conflicts.
"""

import pytest

from hhsuite_tpu_torch.ops import viterbi as TV
from hhsuite_tpu_torch.ops import viterbi_lanes as VL
from test_torch_cuda_emulation import emu_lib  # noqa: F401 (fixture)

SMEM_MAX = 232448


def _rows(geo, Lq):
    rows = [geo.row(p, k, r) for p in range(geo.passes)
            for k in range(geo.G) for r in range(geo.R)]
    return [i for i in rows if i <= Lq], [i for i in rows if i > Lq]


def _lq_cases():
    out = []
    for G in (8, 16, 32):
        GR = G * VL.BT_R
        out += [(G, 1), (G, GR - 1), (G, GR), (G, GR + 1), (G, 512),
                (G, 2000)]
    return out


@pytest.mark.parametrize("G,Lq", _lq_cases())
@pytest.mark.parametrize("ss", [False, True])
def test_every_row_once(emu_lib, G, Lq, ss):
    geo = VL.bt_geometry(37, Lq, 90, G=G)
    assert (geo.G, geo.R) == (G, 8)
    assert geo.groups * geo.G == VL.BT_THREADS == 256
    assert geo.passes == -(-Lq // (G * geo.R))
    real, past = _rows(geo, Lq)
    assert sorted(real) == list(range(1, Lq + 1))
    # rows past Lq only fill the last pass
    assert all(i > (geo.passes - 1) * G * geo.R for i in past)
    # a lane that holds a real row stores its 8 bytes of a column as one
    # aligned word inside the stored column
    for p in range(geo.passes):
        for k in range(G):
            i0 = geo.row(p, k, 0)
            if i0 <= Lq:
                assert (TV.BT_ROW0 + i0) % 8 == 0
                assert TV.BT_ROW0 + i0 + 7 < TV.bt_col_bytes(Lq)
    # the block's shared memory (query rows, template ring, SS table)
    assert 0 < emu_lib.hh_bt_smem_bytes(G, int(ss)) <= SMEM_MAX


@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 320, 512, 2000])
@pytest.mark.parametrize("B", [1, 64, 1024, 4096, 8192])
def test_chosen_geometry_is_valid(B, Lq):
    geo = VL.bt_geometry(B, Lq, 384)
    # G = 16 only where a caller asks for it
    assert geo.G in (8, 32)
    real, _past = _rows(geo, Lq)
    assert sorted(real) == list(range(1, Lq + 1))


def test_cost_model_at_the_path_shapes():
    """phase 1 of chip_smoke.py: 4096 lanes (K2, K3 with SS) take G = 8,
    1024 (K3's altali batches) G = 32, the widths timed on the H100
    (PERF.md)."""
    assert VL.bt_geometry(4096, 320, 384).G == 8
    assert VL.bt_geometry(1024, 320, 384).G == 32
    assert VL.bt_geometry(2048, 320, 384).G == 32


def test_ring_stride_avoids_bank_conflicts(emu_lib):
    """Lane k of group g reads word k*stride + g of a field: the 32
    lanes of a warp hit 32 distinct banks at every width."""
    for G in (8, 16, 32):
        stride = emu_lib.hh_bt_col_stride(G)
        # 28 words a template column, for each of the block's templates
        assert stride >= 28 * (VL.BT_THREADS // G)
        banks = {(k * stride + g) % 32 for g in range(32 // G)
                 for k in range(G)}
        assert len(banks) == 32


def test_geometry_refuses_what_the_kernel_does_not_take(emu_lib):
    with pytest.raises(ValueError):
        VL.bt_geometry(0, 10, 10)
    with pytest.raises(ValueError):
        VL.bt_geometry(4, 0, 10)
    with pytest.raises(ValueError):
        VL.bt_geometry(4, 10, 10, G=4)
    assert emu_lib.hh_bt_smem_bytes(4, 0) == -1
    assert emu_lib.hh_bt_col_stride(64) == -1
