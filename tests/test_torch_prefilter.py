"""The port's cs219 prefilter against the JAX package on the CPU.

* K4 / K5 plain versions (``ops/prefilter.py``) against the JAX scan
  versions and the Pallas kernels in interpret mode, on the same numpy
  inputs: exact integer equality;
* the resident layout's entry points against the public (B, Ld) ones,
  and padding streamed against rows stopped at ``db_len``;
* ``build_query_profile`` byte-identical;
* ``prefilter_db`` on the synthetic many-entry database of
  tests/test_prefilter_funnel.py: identical (new_hits, old_hits) under
  the funnel's cuts (min-hit floor, E-value cut, maxnumdb cap,
  previous-hits split).
"""

import copy
import os

import numpy as np
import pytest
import torch

from hhsuite_tpu.constants import Parameters as JParameters
from hhsuite_tpu.cs.context_lib import ContextLibrary as JContextLibrary
from hhsuite_tpu.ops.prefilter import gapped_scores as jax_gapped
from hhsuite_tpu.ops.prefilter import ungapped_scores as jax_ungapped
from hhsuite_tpu.ops.prefilter_pallas import ungapped_scores_pallas
from hhsuite_tpu.ops.prefilter_pallas2 import gapped_scores_pallas
from hhsuite_tpu.search import prefilter as JPF
from hhsuite_tpu_torch.constants import Parameters
from hhsuite_tpu_torch.cs.context_lib import ContextLibrary
from hhsuite_tpu_torch.io.ffindex import FFindexDatabase
from hhsuite_tpu_torch.matrices import get_substitution_matrix
from hhsuite_tpu_torch.ops import prefilter as P
from hhsuite_tpu_torch.search import prefilter as PF
from hhsuite_tpu_torch.search.query import prepare_query_hmm, read_query_text

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions loop over small tensors and gain little from
    intra-op threads; one thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(Lq, Ld, B, seed, hi=80, density=0.5, offset=50):
    """Seeded query table and padded state matrix (numpy), as the Pallas
    tests build them, in a range where the scores spread."""
    rng = np.random.RandomState(seed)
    qc = (rng.randint(0, hi, size=(220, Lq))
          * (rng.rand(220, Lq) < density)).astype(np.int32)
    qc[219] = offset - 1          # ANY: pure decay
    db = rng.randint(0, 219, size=(B, Ld)).astype(np.int32)
    dl = rng.randint(Ld // 2, Ld + 1, size=B).astype(np.int32)
    for b in range(B):
        db[b, dl[b]:] = 219
    return qc, db, dl


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


SHAPES = [  # Lq, Ld, B, seed
    (100, 64, 24, 1), (33, 50, 7, 2), (128, 40, 130, 3), (200, 90, 16, 4),
    (1, 30, 5, 5),     # Lq = 1
    (57, 1, 9, 6),     # Ld = 1
    (80, 70, 1, 7),    # B = 1
]


@pytest.mark.parametrize("Lq,Ld,B,seed", SHAPES)
def test_k4_plain_equals_jax(Lq, Ld, B, seed):
    qc, db, dl = make_inputs(Lq, Ld, B, seed)
    got = P.ungapped_scores(*_t(qc, db, dl), 50).numpy()
    assert got.dtype == np.int32 and got.shape == (B,)
    want = np.asarray(jax_ungapped(qc, db, dl, np.int32(50)))
    np.testing.assert_array_equal(got, want)
    if Ld > 1:
        assert len(set(got.tolist())) > 1 or B == 1
    pal = np.asarray(ungapped_scores_pallas(qc, db, dl, np.int32(50),
                                            interpret=True))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("Lq,Ld,B,seed", SHAPES)
def test_k5_plain_equals_jax(Lq, Ld, B, seed):
    qc, db, dl = make_inputs(Lq, Ld, B, seed)
    got = P.gapped_scores(*_t(qc, db, dl), 24, 4, 50).numpy()
    want = np.asarray(jax_gapped(qc, db, dl, np.int32(24), np.int32(4),
                                 np.int32(50)))
    np.testing.assert_array_equal(got, want)
    pal = np.asarray(gapped_scores_pallas(qc, db, dl, np.int32(24),
                                          np.int32(4), np.int32(50),
                                          interpret=True))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("gi,ge,off", [(0, 0, 50), (11, 1, 30), (40, 12, 50),
                                       (24, 0, 50)])
def test_k5_plain_gap_penalties_equal_jax(gi, ge, off):
    qc, db, dl = make_inputs(90, 60, 20, 11, offset=off)
    got = P.gapped_scores(*_t(qc, db, dl), gi, ge, off).numpy()
    want = np.asarray(jax_gapped(qc, db, dl, np.int32(gi), np.int32(ge),
                                 np.int32(off)))
    np.testing.assert_array_equal(got, want)


def test_saturation_at_255():
    """A table row at 255 saturates the chains: both stages clamp to
    255 before the offset, exactly as the JAX scans."""
    qc, db, dl = make_inputs(64, 48, 12, 12)
    qc[7] = 255
    db[:, ::3] = 7
    for fn, jfn, args in ((P.ungapped_scores, jax_ungapped, (50,)),
                          (P.gapped_scores, jax_gapped, (24, 4, 50))):
        got = fn(*_t(qc, db, dl), *args).numpy()
        want = np.asarray(jfn(qc, db, dl, *map(np.int32, args)))
        np.testing.assert_array_equal(got, want)
        assert got.max() == 255 - 50


@pytest.mark.parametrize("stage", ["ungapped", "gapped"])
def test_padding_streamed_equals_db_len(stage):
    """Padding with state 219 (row = offset - 1) decays the state, so
    streaming the padding equals stopping at db_len; all-padding rows
    score 0."""
    qc, db, dl = make_inputs(70, 80, 16, 13)
    db[3] = 219
    dl[3] = 0
    fn, args = ((P.ungapped_scores, (50,)) if stage == "ungapped"
                else (P.gapped_scores, (24, 4, 50)))
    stop = fn(*_t(qc, db, dl), *args)
    stream = fn(*_t(qc, db, np.full_like(dl, db.shape[1])), *args)
    torch.testing.assert_close(stop, stream, rtol=0, atol=0)
    assert int(stop[3]) == 0


@pytest.mark.parametrize("stage", ["ungapped", "gapped"])
def test_resident_layout_equals_public(stage):
    """The resident entry points (flat uint8 states, offsets, lengths,
    as ResidentCs219Pack holds them) equal the (B, Ld) wrappers."""
    qc, db, dl = make_inputs(90, 75, 40, 14)
    seqs = [bytes(db[b, : dl[b]].astype(np.uint8)) for b in range(len(dl))]
    packed_db, packed_len = PF.pack_db(seqs, db.shape[1])
    np.testing.assert_array_equal(packed_db, db)
    np.testing.assert_array_equal(packed_len, dl)
    pack = PF.to_device_cs219(seqs, "cpu")
    fn, packed, args = (
        (P.ungapped_scores, P.ungapped_scores_packed, (50,))
        if stage == "ungapped"
        else (P.gapped_scores, P.gapped_scores_packed, (24, 4, 50)))
    want = fn(*_t(qc, db, dl), *args).numpy()
    np.testing.assert_array_equal(
        pack.scores(packed, torch.from_numpy(qc), None, *args), want)
    sub = np.array([31, 2, 17, 5])
    np.testing.assert_array_equal(
        pack.scores(packed, torch.from_numpy(qc), sub, *args), want[sub])


def test_resident_pack_layout():
    seqs = [b"\x01\x02\x03", b"", b"\x05", b"\x07\x08", b"\x09"]
    pack = PF.to_device_cs219(seqs, "cpu")
    assert pack.row_lengths.tolist() == [0, 1, 1, 2, 3]
    assert pack.order.tolist() == [1, 2, 4, 3, 0]        # stable by length
    assert pack.offsets.tolist() == [0, 0, 1, 2, 4]
    assert pack.states.tolist() == [5, 9, 7, 8, 1, 2, 3]
    assert pack.nbytes == 7 + 5 * 8 + 5 * 4
    with pytest.raises(ValueError, match="outside"):
        PF.to_device_cs219([b"\x01\xdc"], "cpu")


def test_kernel_wrappers_take_no_other_device():
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers never fall back to the plain version for it."""
    qc, db, dl = make_inputs(20, 10, 3, 15)
    meta = torch.from_numpy(db).to("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        P.ungapped_scores(torch.from_numpy(qc), meta, torch.from_numpy(dl),
                          50)
    with pytest.raises(ValueError, match=">= 0"):
        P.gapped_scores(torch.from_numpy(qc), meta, torch.from_numpy(dl),
                        -1, 4, 50)


# ------------------------------------------------------ prefilter_db ----

@pytest.fixture(scope="module")
def setup():
    """The synthetic many-entry setup of tests/test_prefilter_funnel.py:
    26 real cs219 sequences + 400 random ones, the query prepared with
    prefilter pseudocounts, in both packages."""
    from hhsuite_tpu.matrices import get_substitution_matrix as jmats
    from hhsuite_tpu.search.query import prepare_query_hmm as jprep
    from hhsuite_tpu.search.query import read_query_text as jread

    with open(f"{FIX}/query.a3m") as f:
        text = f.read()
    out = []
    for Par, mats_fn, read, prep in (
            (Parameters, get_substitution_matrix, read_query_text,
             prepare_query_hmm),
            (JParameters, jmats, jread, jprep)):
        par = Par.hhblits_defaults()
        par.nocontxt = True
        mats = mats_fn(par.matrix)
        q, _qali, fmt = read(par, text, "query.a3m", mats)
        q_tmp = copy.deepcopy(q)
        prep(par, q_tmp, mats, fmt)
        q_tmp.prepare_pseudocounts(mats.R)
        q_tmp.add_amino_acid_pseudocounts(
            par.pc_prefilter_nocontext_mode, par.pc_prefilter_nocontext_a,
            par.pc_prefilter_nocontext_b, par.pc_prefilter_nocontext_c)
        q_tmp.calculate_aa_background(mats.pb)
        out.append((par, q_tmp))
    cs = FFindexDatabase(f"{FIX}/multi_cs219.ffdata",
                         f"{FIX}/multi_cs219.ffindex")
    names = [e.name for e in cs.entries]
    seqs = [cs.read_bytes(e).rstrip(b"\x00") for e in cs.entries]
    rng = np.random.RandomState(0)
    for k in range(400):
        L = rng.randint(30, 500)
        names.append(f"rand{k:04d}")
        seqs.append(bytes(rng.randint(0, 219, L, dtype=np.uint8)))
    (par, q_tmp), (jpar, jq_tmp) = out
    return (par, q_tmp, ContextLibrary.default_cs219(), jpar, jq_tmp,
            JContextLibrary.default_cs219(), names, seqs)


def test_build_query_profile_byte_identical(setup):
    par, q_tmp, lib, jpar, jq_tmp, jlib, _names, _seqs = setup
    got = PF.build_query_profile(q_tmp, lib, par.prefilter_score_offset,
                                 par.prefilter_bit_factor)
    want = JPF.build_query_profile(jq_tmp, jlib, jpar.prefilter_score_offset,
                                   jpar.prefilter_bit_factor)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


def _cut(par, case, names):
    if case == "evalue_cut":
        par.prefilter_evalue_thresh = 1e-3
        par.min_prefilter_hits = 1
    elif case == "min_hit_floor":
        par.prefilter_evalue_thresh = 0.0
        par.prefilter_evalue_coarse_thresh = 1e30
        par.min_prefilter_hits = 7
    elif case == "maxnumdb_cap":
        par.maxnumdb = 9
    elif case == "smax_cut":
        par.preprefilter_smax_thresh = 40
        par.min_prefilter_hits = 3


@pytest.mark.parametrize("case", ["defaults", "evalue_cut", "min_hit_floor",
                                  "maxnumdb_cap", "smax_cut",
                                  "previous_hits"])
def test_prefilter_db_equals_jax(setup, case):
    par, q_tmp, lib, jpar, jq_tmp, jlib, names, seqs = setup
    par, jpar = copy.deepcopy(par), copy.deepcopy(jpar)
    _cut(par, case, names)
    _cut(jpar, case, names)
    prev = None
    if case == "previous_hits":
        top = [n for (_l, n) in JPF.prefilter_db(jpar, jq_tmp, jlib, names,
                                                 seqs)[0]][:3]
        prev = {n.rsplit(".", 1)[0] + "__1" for n in top}
    counts = {}
    got = PF.prefilter_db(par, q_tmp, lib, names, seqs,
                          previous_hit_names=prev, device="cpu",
                          counts=counts)
    want = JPF.prefilter_db(jpar, jq_tmp, jlib, names, seqs,
                            previous_hit_names=prev)
    assert got == want
    assert counts["stage2"] >= len(got[0]) + len(got[1])
    assert counts["stage1"] >= counts["stage2"]
    if case == "previous_hits":
        assert sorted(n for (_l, n) in got[1]) == sorted(top)
    if case == "maxnumdb_cap":
        assert len(got[0]) == 9
    if case == "min_hit_floor":
        assert len(got[0]) == 7


def test_prefilter_db_reuses_a_given_pack(setup):
    par, q_tmp, lib, _jpar, _jq, _jlib, names, seqs = setup
    pack = PF.to_device_cs219(seqs, "cpu")
    assert (PF.prefilter_db(par, q_tmp, lib, names, seqs, pack=pack)
            == PF.prefilter_db(par, q_tmp, lib, names, seqs, device="cpu"))
    with pytest.raises(ValueError, match="rows"):
        PF.prefilter_db(par, q_tmp, lib, names[:-1], seqs[:-1], pack=pack)
