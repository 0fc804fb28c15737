"""The realign path's SS factors as a table (``search/posterior.py:
PosteriorDecoder.ss_table``, read by R1/R2 through ``ops/posterior_batch.
py``'s ``ss_table`` form) against the dense fill it replaces.

The dense fill: a (B, Lq+1, Wj) f32 matrix of ones, each SS lane's
columns 0..t.L set to ``fpow2`` of ``_ss_matrix`` (the reference's
clamped indices, row and column 0 included).  The table expanded through
its offsets (``ss_expand``) must equal it bit for bit for every mode, for
SS and non-SS lanes in one chunk, columns past ``t.L`` and padding
lanes; offsets out of range raise; and the plain R1-R3 on the CPU give
the same bits from either form.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (REALIGN_MACT, REALIGN_SHIFT, realign_inputs)
from hhsuite_tpu_torch import fastmath as fm
from hhsuite_tpu_torch.constants import MAXCF, NDSSP, NSSPRED
from hhsuite_tpu_torch.matrices import get_ss_matrices
from hhsuite_tpu_torch.ops import posterior_batch as PB
from hhsuite_tpu_torch.search.posterior import PosteriorDecoder


def _decoder():
    m = get_ss_matrices()
    return PosteriorDecoder(True, 0.11, m.S73, m.S37, m.S33)


def _hmm(rng, L, n):
    """SS states of an HMM of length L, n entries each (fewer than L + 1
    make _ss_matrix clamp)."""
    return SimpleNamespace(
        L=L, ss_pred=rng.integers(0, NSSPRED, n).astype(np.int8),
        ss_conf=rng.integers(0, MAXCF, n).astype(np.int8),
        ss_dssp=rng.integers(0, NDSSP, n).astype(np.int8))


def _dense_fill(dec, q, lanes, B, Wj):
    """The realign path's former dense SS factors."""
    ss_f = np.ones((B, q.L + 1, Wj), np.float32)
    for b, (t, ssm) in enumerate(lanes):
        if ssm:
            m = dec._ss_matrix(q, t, ssm)
            ss_f[b, :, : t.L + 1] = fm.fpow2(
                m[: q.L + 1, : t.L + 1].astype(np.float32))
    return ss_f


def _chunk(seed, modes, Lq=23, Wj=61):
    """A query whose SS arrays are shorter than Lq + 1, lanes of the
    given modes over templates of ragged lengths (one with short SS
    arrays), and a padding lane."""
    rng = np.random.default_rng(seed)
    q = _hmm(rng, Lq, Lq - 2)
    lanes = []
    for b, ssm in enumerate(modes):
        L = int(rng.integers(5, Wj))
        lanes.append((_hmm(rng, L, L - 3 if b == 0 else L + 2), ssm))
    return q, lanes, len(modes) + 1, Wj


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("ssm", [1, 2, 3])
def test_table_expands_to_the_dense_fill(ssm):
    dec = _decoder()
    q, lanes, B, Wj = _chunk(ssm, [ssm] * 4)
    lut, roff, coff = dec.ss_table(q, lanes, B, Wj)
    assert lut.dtype == np.float32 and lut[0] == 1.0
    assert roff.shape == (B, q.L + 1) and coff.shape == (B, Wj)
    got = PB.ss_expand(torch.from_numpy(lut), torch.from_numpy(roff),
                       torch.from_numpy(coff)).numpy()
    want = _dense_fill(dec, q, lanes, B, Wj)
    assert _same_bits(got, want)
    # rows and column 0 are the reference's clamped values, not ones
    assert not np.all(want[0, 0] == 1.0) and not np.all(want[0, :, 0] == 1.0)
    # past each template's length and on the padding lane: ones
    assert np.all(got[-1] == 1.0)
    for b, (t, _m) in enumerate(lanes):
        assert np.all(got[b, :, t.L + 1:] == 1.0)


def test_table_mixes_ss_and_non_ss_lanes():
    dec = _decoder()
    q, lanes, B, Wj = _chunk(7, [1, 0, 2, 3, 0, 2])
    lut, roff, coff = dec.ss_table(q, lanes, B, Wj)
    got = PB.ss_expand(torch.from_numpy(lut), torch.from_numpy(roff),
                       torch.from_numpy(coff)).numpy()
    assert _same_bits(got, _dense_fill(dec, q, lanes, B, Wj))
    assert np.all(got[1] == 1.0) and np.all(got[4] == 1.0)
    assert (coff[1] == -1).all() and (roff[1] == 0).all()


def test_table_holds_every_mode_fpow2():
    dec = _decoder()
    lut = dec.ss_lut()
    parts = [np.ones(1, np.float32)] + [
        fm.fpow2((dec.ssw * S).reshape(-1).astype(np.float32))
        for S in (dec.S37, dec.S73, dec.S33)]
    assert len(lut) == 1 + 352 + 352 + 1936 <= PB.SS_LUT_MAX
    assert _same_bits(lut, np.concatenate(parts))


@pytest.mark.parametrize("bad", ["conf past MAXCF", "negative dssp"])
def test_table_offsets_out_of_range_raise(bad):
    dec = _decoder()
    rng = np.random.default_rng(3)
    q = _hmm(rng, 12, 13)
    t = _hmm(rng, 9, 11)
    if bad == "negative dssp":
        t.ss_dssp[4] = -1
        ssm = 1
    else:
        q.ss_pred[:], q.ss_conf[:] = NSSPRED - 1, MAXCF - 1
        t.ss_pred[2], t.ss_conf[2] = NSSPRED - 1, MAXCF
        ssm = 3
    with pytest.raises(ValueError, match="out of range"):
        dec.ss_table(q, [(t, ssm)], 2, 16)


@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
def test_fb_mac_rows_table_form_equals_dense_form(local):
    x = realign_inputs(14, 130, 5, 1, "mix", seed=29, device="cpu",
                       extras="pad")
    args = (x["qp"], x["qtr"], x["tp"], x["ttr"], x["co"], REALIGN_SHIFT,
            REALIGN_MACT)
    dense = PB.fb_mac_rows(*args, x["ss_f"], x["ss0"], local=local,
                           t_L=x["t_L"])
    table = PB.fb_mac_rows(*args, None, x["ss0"], local=local,
                           t_L=x["t_L"], ss_table=x["ss_table"])
    for a, b in zip(dense, table):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
    # the chunk really scores SS: factors away from 1 on its SS lanes
    assert not torch.all(x["ss_f"][0] == 1.0)
    with pytest.raises(ValueError, match="not both"):
        PB.fb_mac_rows(*args, x["ss_f"], x["ss0"], local=local,
                       t_L=x["t_L"], ss_table=x["ss_table"])
