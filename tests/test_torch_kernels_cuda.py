"""The CUDA kernels against their plain PyTorch versions on the card:
the Viterbi kernels (K1, K2, K3, K6) bit for bit, the prefilter kernels (K4,
K5) as integers — phase 1 of ``chip_smoke.py``, at small shapes, at the
prefilter's path shape and at long queries; K1/K6 and K2/K3 also at the
edges of their wavefronts (one row, a pass of G*R rows less one,
exactly, plus one, several passes, at each group width G; one column;
fewer columns than lanes; one template; a block not filled; a lane of
padding only), and K4 and K5 at their wavefront's edges at each group
width, with the sequences of one warp far apart in length; the realign
kernels R1-R3 bit for bit and R4 byte for byte at their edges
(``chip_smoke.realign_edge_shapes``) and at the path's chunk of 256 hits,
SS off, dense and as a table (R1/R2 in both SS forms), local and
global; the walk W1 byte for byte on K2/K3's
storage view and on contiguous bytes at every K2/K3 edge shape, with a
lane of padding, planted codes 1 and 7 and a short kmax, and at the
emulation test's planted walks (diagonal, row and column runs, rows and
columns 1, random codes, a short kmax; ``-k walk``);
R3 alone at the emulation test's planted posteriors (rows of 1-9
columns a thread, ties, no open cell; ``-k mac_dp``).
Needs a CUDA card;
elsewhere every test skips.  On a
machine with a card:
python -m pytest -m gpu tests/test_torch_kernels_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from hhsuite_tpu_torch.ops import prefilter as PK
from hhsuite_tpu_torch.ops import viterbi as TV
from hhsuite_tpu_torch.ops import viterbi_lanes as VL
from hhsuite_tpu_torch.ops.viterbi_lanes import (viterbi_backtrace_lanes,
                                                 viterbi_score_lanes,
                                                 viterbi_score_lanes_fused,
                                                 viterbi_score_lanes_plain)
from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows
from hhsuite_tpu_torch.search.viterbi_search import to_device_pack
from hhsuite_tpu_torch.search.prefilter import to_device_cs219
from chip_smoke import (B_RE, LQ_RE, LT_RE, REALIGN_MACT, REALIGN_SHIFT,
                        bt_edge_shapes, k4_edge_shapes, k5_edge_inputs,
                        k5_edge_shapes, realign_check, realign_edge_shapes,
                        realign_inputs, score_edge_shapes)
from hhsuite_tpu_torch.ops import posterior_batch as PB
from test_torch_prefilter import SHAPES as PF_SHAPES
from test_torch_prefilter import make_inputs as pf_inputs
from test_torch_viterbi import make_inputs
from test_torch_viterbi_kernels import _ss_lut_inputs
from test_torch_cuda_emulation import (WALK_CASES, WALK_TILE_CASES,
                                       _walk_case_id, _walk_tile_id,
                                       check_walk_payload,
                                       check_walk_tile_payload, walk_case,
                                       walk_tile_case)
from test_torch_posterior_emulation import (MAC_CASES, check_mac_dp,
                                            mac_dp_case)

pytestmark = pytest.mark.gpu

SHAPES = [(37, 29, 40), (64, 100, 70), (130, 77, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, shape, seed, pad_last=False):
    qp, qtr, tp, ttr, t_L, co, ss = make_inputs(*shape, seed=seed)
    if pad_last:     # a lane of padding only, as pack_templates pads
        tp[-1], ttr[-1] = 0.0, -TV.FLT_MAX
    tp_d, ttr_d, tl_d = to_device_pack(tp, ttr, t_L, dev)
    return (torch.from_numpy(qp).to(dev), torch.from_numpy(qtr).to(dev),
            tp_d, ttr_d, tl_d, torch.from_numpy(co).to(dev),
            torch.from_numpy(ss).to(dev))


def _same(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(512, 60, 12), (320, 384, 300)])
@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_k1_kernel_bit_identical(cuda, shape, mode):
    qp, qtr, tp, ttr, tl, _co, _ss = _on(cuda, shape, 1)
    n = viterbi_score_lanes_fused.launches
    got = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tl, -0.03,
                                    si_mode=mode)
    assert viterbi_score_lanes_fused.launches == n + 1
    want = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tl, -0.03,
                                     si_mode=mode)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_kernel_bit_identical(cuda, shape):
    qp, qtr, tp, ttr, tl, _co, _ss = _on(cuda, shape, 2)
    got = viterbi_backtrace_lanes(qp, qtr, tp, ttr, tl, -0.03,
                                  Lq_true=shape[0] - 3)
    want = TV.viterbi_batch(qp, qtr, tp, ttr, None, tl, -0.03,
                            Lq_true=shape[0] - 3)
    _check_bt(got, want, shape[0] + shape[1] + 1)


def _ss_table(dev, shape, seed):
    lut, qidx, tidx, _dense = _ss_lut_inputs(*shape, seed=seed)
    return {k: torch.from_numpy(x).to(dev) for k, x in
            (("ss_lut", lut), ("ss_qidx", qidx), ("ss_tidx", tidx))}


def _check_bt(got, want, kmax):
    """score, i2, j2 and bt bit for bit, and the same walk payload: W1 on
    the kernel's bt, the plain walk on the plain version's."""
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same(a, b)
    n = TV.backtrace_walk_packed8.launches
    pa = TV.backtrace_walk_packed8(got[3], *got[1:3], got[0], kmax)
    assert TV.backtrace_walk_packed8.launches == n + 1
    pb = TV.backtrace_walk_packed8_plain(want[3], *want[1:3], want[0], kmax)
    assert torch.equal(pa, pb)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("local,use_co,use_ss", [
    (True, True, False), (False, False, False), (False, True, False),
    (True, False, True), (False, True, True)])
def test_k3_kernel_bit_identical(cuda, shape, local, use_co, use_ss):
    qp, qtr, tp, ttr, tl, co, _ss = _on(cuda, shape, 3)
    co = co if use_co else None
    kw = _ss_table(cuda, shape, 9) if use_ss else {}
    got = viterbi_batch_rows(qp, qtr, tp, ttr, co, tl, -0.03, local=local,
                             **kw)
    want = TV.viterbi_batch(qp, qtr, tp, ttr, co, tl, -0.03, local=local,
                            **kw)
    _check_bt(got, want, shape[0] + shape[1] + 1)


def test_k3_refuses_dense_ss_on_the_card(cuda):
    qp, qtr, tp, ttr, tl, _co, ss = _on(cuda, (37, 29, 40), 3)
    with pytest.raises(ValueError, match="table"):
        viterbi_batch_rows(qp, qtr, tp, ttr, None, tl, -0.03, ss_score=ss)


def test_kernels_take_exclusion_masks_in_place(cuda):
    """The device-built exclusion mask is a view of the kernel's
    storage; the kernel reads it without a copy and matches the plain
    version."""
    shape = (64, 100, 70)
    qp, qtr, tp, ttr, tl, _co, _ss = _on(cuda, shape, 4)
    rng = np.random.default_rng(4)
    B, Li, Wj = shape[2], shape[0] + 1, shape[1] + 1
    lo_c = rng.integers(0, Li, (B, 2, Wj)).astype(np.int16)
    hi_c = (lo_c + rng.integers(-3, 30, (B, 2, Wj))).astype(np.int16)
    lo_r = rng.integers(0, Wj, (B, 2, Li)).astype(np.int16)
    hi_r = (lo_r + rng.integers(-3, 30, (B, 2, Li))).astype(np.int16)
    mask = TV.exclusion_mask_device(*(torch.from_numpy(x).to(cuda)
                                      for x in (lo_c, hi_c, lo_r, hi_r)))
    assert TV.bt_base(mask) is not None
    got = viterbi_batch_rows(qp, qtr, tp, ttr, mask, tl, -0.03)
    want = TV.viterbi_batch(qp, qtr, tp, ttr, mask.contiguous(), tl, -0.03)
    _check_bt(got, want, shape[0] + shape[1] + 1)


@pytest.mark.parametrize("G,Lq,Lt,B", [e for e in bt_edge_shapes() if e[0]])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_bt_kernel_wavefront_edges(cuda, monkeypatch, kernel, G, Lq, Lt,
                                   B):
    monkeypatch.setattr(VL, "bt_geometry",
                        functools.partial(VL.bt_geometry, G=G))
    qp, qtr, tp, ttr, tl, co, _ss = _on(cuda, (Lq, Lt, B), 10 + G)
    if kernel == "K2":
        got = viterbi_backtrace_lanes(qp, qtr, tp, ttr, tl, -0.03,
                                      Lq_true=max(1, Lq - 2))
        want = TV.viterbi_batch(qp, qtr, tp, ttr, None, tl, -0.03,
                                Lq_true=max(1, Lq - 2))
    else:
        kw = _ss_table(cuda, (Lq, Lt, B), G)
        got = viterbi_batch_rows(qp, qtr, tp, ttr, co, tl, -0.03,
                                 local=False, **kw)
        want = TV.viterbi_batch(qp, qtr, tp, ttr, co, tl, -0.03,
                                local=False, **kw)
    _check_bt(got, want, Lq + Lt + 1)


@pytest.mark.parametrize("local", [True, False])
def test_k3_query_longer_than_k2_takes(cuda, local):
    """Lq = 513, past K2's 512 rows: the search routes it to K3."""
    shape = (513, 60, 12)
    qp, qtr, tp, ttr, tl, co, _ss = _on(cuda, shape, 11)
    kw = _ss_table(cuda, shape, 12)
    got = viterbi_batch_rows(qp, qtr, tp, ttr, co, tl, -0.03, local=local,
                             **kw)
    want = TV.viterbi_batch(qp, qtr, tp, ttr, co, tl, -0.03, local=local,
                            **kw)
    _check_bt(got, want, shape[0] + shape[1] + 1)


# K6 at small shapes (Lq, Lt, B): short queries (one partial lane of 8
# rows, one lane plus one row, two lanes plus one row), one template,
# one template column; the table offsets reach both ends of the table in
# every case
K6_SHAPES = [(1, 40, 33), (9, 40, 33), (17, 50, 65), (37, 29, 1),
             (25, 1, 40)]


@pytest.mark.parametrize("shape", K6_SHAPES)
def test_k6_kernel_bit_identical(cuda, shape):
    qp, qtr, tp, ttr, tl, _co, _ss = _on(cuda, shape, 6)
    lut, qidx, tidx, dense = (torch.from_numpy(x).to(cuda)
                              for x in _ss_lut_inputs(*shape, seed=7))
    n = viterbi_score_lanes.launches
    got = viterbi_score_lanes(qp, qtr, tp, ttr, tl, -0.03, ss_lut=lut,
                              ss_qidx=qidx, ss_tidx=tidx)
    assert viterbi_score_lanes.launches == n + 1
    want = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tl, -0.03,
                                     ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
    got_dense = viterbi_score_lanes(qp, qtr, tp, ttr, tl, -0.03,
                                    ss_score=dense)
    got_none = viterbi_score_lanes(qp, qtr, tp, ttr, tl, -0.03)
    k1_exact = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tl, -0.03,
                                         si_mode="exact")
    torch.cuda.synchronize()
    assert _same(got, want) and _same(got_dense, got)
    assert _same(got_none, k1_exact)


@pytest.mark.parametrize("G,Lq,Lt,B,pad", score_edge_shapes())
@pytest.mark.parametrize("mode", ["fast", "exact", "table", "dense"])
def test_score_kernel_wavefront_edges(cuda, monkeypatch, mode, G, Lq, Lt,
                                      B, pad):
    monkeypatch.setattr(VL, "score_geometry",
                        functools.partial(VL.score_geometry, G=G))
    qp, qtr, tp, ttr, tl, _co, ss = _on(cuda, (Lq, Lt, B), 20 + Lq,
                                        pad_last=pad)
    kw = {"table": _ss_table(cuda, (Lq, Lt, B), Lt),
          "dense": dict(ss_score=ss)}.get(mode)
    if kw is None:
        got = viterbi_score_lanes_fused(qp, qtr, tp, ttr, tl, -0.03,
                                        si_mode=mode)
        want = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tl, -0.03,
                                         si_mode=mode)
    else:
        got = viterbi_score_lanes(qp, qtr, tp, ttr, tl, -0.03, **kw)
        want = viterbi_score_lanes_plain(qp, qtr, tp, ttr, tl, -0.03, **kw)
    torch.cuda.synchronize()
    assert _same(got, want) and torch.isfinite(got).all()


PF_STAGES = {"K4": (PK.ungapped_scores, PK.ungapped_scores_plain,
                    PK.ungapped_scores_packed, (50,)),
             "K5": (PK.gapped_scores, PK.gapped_scores_plain,
                    PK.gapped_scores_packed, (24, 4, 50))}


@pytest.mark.parametrize("shape", PF_SHAPES + [
    (1024, 80, 40, 21),      # the longest table kept in shared memory
    (1025, 80, 40, 22),      # table read from global memory
    (2000, 150, 64, 23)])
@pytest.mark.parametrize("stage", ["K4", "K5"])
def test_prefilter_kernel_int_identical(cuda, shape, stage):
    kern, plain, _packed, args = PF_STAGES[stage]
    qc, db, dl = (torch.from_numpy(x).to(cuda) for x in pf_inputs(*shape))
    n = kern.launches
    got = kern(qc, db, dl, *args)
    assert kern.launches == n + 1
    want = plain(qc, db, dl, *args)
    streamed = kern(qc, db, torch.full_like(dl, db.shape[1]), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, streamed)


def _force_pf_width(monkeypatch, G):
    geometry = PK.pf_geometry
    monkeypatch.setattr(PK, "pf_geometry",
                        lambda *a, **kw: geometry(*a, **kw, G=G))


@pytest.mark.parametrize("stage,case",
                         [("K5", c) for c in k5_edge_shapes()]
                         + [("K4", c) for c in k4_edge_shapes()],
                         ids=lambda c: c if isinstance(c, str)
                         else f"G{c[1]}-{c[0]}")
def test_prefilter_kernel_wavefront_edges(cuda, monkeypatch, stage, case):
    tag, G, Lq, _Ld, _B, _lens, args = case
    kern, plain, _packed, _args = PF_STAGES[stage]
    _force_pf_width(monkeypatch, G)
    qc, db, dl = (torch.from_numpy(x).to(cuda)
                  for x in k5_edge_inputs(case, seed=Lq + G))
    n = kern.launches
    got = kern(qc, db, dl, *args)
    assert kern.launches == n + 1
    want = plain(qc, db, dl, *args)
    streamed = kern(qc, db, torch.full_like(dl, db.shape[1]), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, streamed)
    if tag.startswith("row at 255"):
        assert int(got.max()) == 255 - args[-1]


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("stage", ["K4", "K5"])
def test_prefilter_warp_of_far_apart_lengths(cuda, monkeypatch, stage, G):
    """Unsorted rows, so the groups of a warp end thousands of steps
    apart (lengths 0 to 2000), at Lq = 300 (5, 3 or 2 passes)."""
    kern, plain, _packed, args = PF_STAGES[stage]
    _force_pf_width(monkeypatch, G)
    rng = np.random.default_rng(G)
    lens = rng.choice([0, 1, 3, 40, 300, 1200, 2000], 96)
    qc, db, _dl = pf_inputs(300, 2000, 96, G)
    for b, n in enumerate(lens):
        db[b, n:] = 219
    qc, db, dl = (torch.from_numpy(x).to(cuda)
                  for x in (qc, db, lens.astype(np.int32)))
    got = kern(qc, db, dl, *args)
    want = plain(qc, db, dl, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.max()) > 0
    assert not got[dl == 0].any()


@pytest.mark.parametrize("stage", ["K4", "K5"])
def test_prefilter_kernel_path_shape(cuda, stage):
    """chip_smoke's phase-1 shape: 65,536 long-tail sequences in the
    resident layout, Lq = 300."""
    import chip_smoke

    _kern, plain, packed, args = PF_STAGES[stage]
    rng = np.random.default_rng(5)
    lens = chip_smoke.long_tail_lengths(rng, 1 << 16)
    pack = to_device_cs219([rng.integers(0, 219, n, dtype=np.uint8).tobytes()
                            for n in lens], cuda)
    qc = torch.from_numpy(chip_smoke.prefilter_table(rng, 300)).to(cuda)
    rows = (pack.states, pack.offsets, pack.row_lengths)
    got = packed(qc, *rows, *args)
    want = PK.packed_plain(plain, qc, *rows, *args, chunk=1 << 16)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.max()) > 0


REALIGN_CASES = realign_edge_shapes() + [
    ("path chunk", LQ_RE, LT_RE, B_RE, 3, ss, local, "pad")
    for ss in (False, True, "mix") for local in (True, False)]


def _realign_id(c):
    ss = c[5] if isinstance(c[5], str) else int(c[5])
    return f"{c[0]}-ss{ss}-loc{int(c[6])}"


@pytest.mark.parametrize("case", REALIGN_CASES, ids=_realign_id)
def test_realign_kernels_bit_identical(cuda, case):
    tag, Lq, Lt_pad, B, P, ss, local, extras = case
    x = realign_inputs(Lq, Lt_pad, B, P, ss, seed=Lq + B, device=cuda,
                       extras=extras)
    counters = (PB.fb_forward, PB.fb_backward, PB.mac_dp,
                PB.mac_walk_packed8)
    n0 = [f.launches for f in counters]
    realign_check(x, local, tag)      # raises where a kernel differs
    # R1 and R2 once a SS form (the dense one, and the table if any)
    nf = 1 + (x["ss_table"] is not None)
    assert [f.launches for f in counters] == [
        n0[0] + nf, n0[1] + nf, n0[2] + 1, n0[3] + 1]


def test_realign_kernels_global_scratch(cuda, monkeypatch):
    """Rows too wide for shared memory keep their arrays in the global
    scratch: forced here at a row of 9 columns a thread (R1/R2 keep
    narrower rows in registers)."""
    monkeypatch.setattr(PB, "SMEM_MAX", 0)
    x = realign_inputs(40, 1100, 6, 2, True, seed=3, device=cuda,
                       extras="pad")
    args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], REALIGN_SHIFT,
            REALIGN_MACT, x["ss_f"], x["ss0"], True, x["t_L"])
    got = PB.fb_mac_batch(*args)
    monkeypatch.setattr(PB, "fb_forward", PB.fb_forward_plain)
    monkeypatch.setattr(PB, "fb_backward", PB.fb_backward_plain)
    monkeypatch.setattr(PB, "mac_dp", PB.mac_dp_plain)
    want = PB.fb_mac_batch(*args)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", WALK_CASES, ids=_walk_case_id)
def test_walk_kernel_byte_identical(cuda, case):
    args, bt = walk_case(*case, device=cuda)
    if case[3] == "storage":
        assert TV.bt_base(args[0]) is not None
    n = TV.backtrace_walk_packed8.launches
    got = TV.backtrace_walk_packed8(*args)
    torch.cuda.synchronize()
    assert TV.backtrace_walk_packed8.launches == n + 1
    check_walk_payload(got, case, bt, *args[1:])


def test_walk_kernel_refusals(cuda):
    (bt, i2, j2, score, _kmax), _bt = walk_case(37, 29, 11, "contiguous",
                                                "pad", device=cuda)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        TV.backtrace_walk_packed8(bt, i2, j2, score, 0)
    with pytest.raises(ValueError, match="uint8"):
        TV.backtrace_walk_packed8(bt.to(torch.int8), i2, j2, score, 10)


@pytest.mark.parametrize("case", WALK_TILE_CASES, ids=_walk_tile_id)
def test_walk_kernel_tiles_byte_identical(cuda, case):
    pattern, layout = case
    args, bt = walk_tile_case(pattern, layout, device=cuda)
    n = TV.backtrace_walk_packed8.launches
    got = TV.launch_walk(*args)
    torch.cuda.synchronize()
    assert TV.backtrace_walk_packed8.launches == n + 1
    check_walk_tile_payload(got, pattern, bt, *args[1:])


@pytest.mark.parametrize("case", MAC_CASES, ids=lambda c: c[0])
def test_mac_dp_kernel_bit_identical(cuda, case):
    _tag, Lq, Lt_pad, B, local, pattern = case
    x = mac_dp_case(Lq, Lt_pad, B, local, pattern, device=cuda)
    n = PB.mac_dp.launches
    got = PB.mac_dp(x["p_mm"], x["co"], REALIGN_MACT, local, x["t_L"])
    torch.cuda.synchronize()
    assert PB.mac_dp.launches == n + 1
    check_mac_dp(got, x, local, pattern)
