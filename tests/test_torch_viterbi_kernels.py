"""Plain versions of the port's Viterbi kernels (K1, K2, K3, K6) against
the JAX package on the same numpy inputs.

On the CPU each kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held against those plain versions bit for bit on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).  Tolerances:

* K1 ``exact`` vs JAX ``viterbi_batch``: rtol 1e-6 / atol 1e-4 — the
  profile dot's summation order (XLA einsum vs the SSE tree) and K1's
  factored max trees (viterbi_lanes.py:537-552) differ by ulps;
* K1 ``fast``: atol 0.05 — the quartic log2's 0.000146 bit/cell bound;
* K1 vs JAX ``viterbi_score_lanes_fused(interpret=True)``: that test's
  own rtol 2e-3 / atol 0.3, because the JAX kernel casts its dot operands
  to bf16 (tests/test_viterbi_lanes_fused.py:31-47);
* K3 vs JAX ``viterbi_batch_rows(interpret=True)``, with and without a
  cell-off mask and SS (the port's table form against the dense matrix
  it defines): identical backtrace bytes and end cells, scores within
  rtol 1e-6 / atol 1e-4 (the JAX kernel's tree scans drift by ~1 ulp,
  viterbi_rows.py:34-38);
* K6 vs JAX ``viterbi_score_lanes(si_dtype="float32", interpret=True)``,
  dense and LUT SS: rtol 2e-6 / atol 1e-4, the profile dot's summation
  order (as tests/test_viterbi_lanes.py holds the JAX kernel to its
  scan reference).  Within the port, K6's LUT form equals its dense form
  and K6 without SS equals K1 ``exact``, bit for bit.
"""

import numpy as np
import pytest
import torch

from hhsuite_tpu.ops import viterbi as JV
from hhsuite_tpu.ops.viterbi_lanes import viterbi_score_lanes as jax_k6
from hhsuite_tpu.ops.viterbi_lanes import viterbi_score_lanes_fused as jax_k1
from hhsuite_tpu.ops.viterbi_rows import viterbi_batch_rows as jax_k3
from hhsuite_tpu_torch.ops import viterbi as TV
from hhsuite_tpu_torch.ops.viterbi_lanes import (viterbi_backtrace_lanes,
                                                 viterbi_score_lanes,
                                                 viterbi_score_lanes_fused)
from hhsuite_tpu_torch.ops.viterbi_rows import viterbi_batch_rows
from hhsuite_tpu_torch.search.viterbi_search import to_device_pack
from test_torch_viterbi import make_inputs

SHAPES = [(37, 29, 4), (25, 21, 3), (40, 23, 5)]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _args(qp, qtr, tp, ttr, t_L):
    """The search path's form of the inputs: query tensors plus the
    template pack in lanes-last storage (``to_device_pack``)."""
    return _t(qp, qtr) + list(to_device_pack(tp, ttr, t_L, "cpu"))


def _jax_scores(qp, qtr, tp, ttr, t_L):
    B, Lq, Lt = tp.shape[0], qp.shape[0] - 2, tp.shape[1] - 2
    co = np.zeros((B, Lq + 1, Lt + 1), bool)
    return np.asarray(JV.viterbi_batch(qp, qtr, tp, ttr, co, t_L, -0.03,
                                       0.0, 0.0, 0.0, local=True)[0])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode,atol", [("exact", 1e-4), ("fast", 0.05)])
def test_k1_plain_matches_jax_viterbi(shape, mode, atol):
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(*shape, seed=1)
    want = _jax_scores(qp, qtr, tp, ttr, t_L)
    before = viterbi_score_lanes_fused.launches
    got = viterbi_score_lanes_fused(*_args(qp, qtr, tp, ttr, t_L), -0.03,
                                    si_mode=mode).numpy()
    assert viterbi_score_lanes_fused.launches == before  # plain on CPU
    np.testing.assert_allclose(got, want, rtol=1e-6 if mode == "exact"
                               else 1e-3, atol=atol)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_k1_plain_matches_jax_fused_interpret(mode):
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(37, 29, 4, seed=2)
    want = np.asarray(jax_k1(qp, qtr, tp, ttr, t_L, np.float32(-0.03),
                             si_mode=mode, interpret=True))
    got = viterbi_score_lanes_fused(*_args(qp, qtr, tp, ttr, t_L), -0.03,
                                    si_mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.3)


def test_k1_zero_profile_rows_never_win():
    """Query rows of zero profile (the Lq bucket's padding) score
    log2(0) + shift ~ -127 per cell and never raise a template's best
    score."""
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(25, 21, 3, seed=3)
    qp[-1] = 0.0
    base = viterbi_score_lanes_fused(*_t(qp, qtr, tp, ttr, t_L), -0.03)
    qp_pad = np.zeros((32 + 2, 20), np.float32)
    qp_pad[:27] = qp
    qtr_pad = np.full((32 + 2, 7), -np.finfo(np.float32).max, np.float32)
    qtr_pad[:27] = qtr
    padded = viterbi_score_lanes_fused(*_t(qp_pad, qtr_pad, tp, ttr, t_L),
                                       -0.03)
    np.testing.assert_array_equal(padded.numpy(), base.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_matches_jax_viterbi(shape):
    """K2's parity reference: score, end cell and path of
    ``viterbi_batch`` (local, no cell-off, no SS)."""
    Lq, Lt, B = shape
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(Lq, Lt, B, seed=5)
    co = np.zeros((B, Lq + 1, Lt + 1), bool)
    sj, ij, jj, btj = [np.asarray(x) for x in JV.viterbi_batch(
        qp, qtr, tp, ttr, co, t_L, -0.03, 0.0, 0.0, 0.0, local=True)]
    st, it, jt, btt = viterbi_backtrace_lanes(
        *_args(qp, qtr, tp, ttr, t_L), -0.03, Lq_true=Lq)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(jt.numpy(), jj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6, atol=1e-4)
    kmax = Lq + Lt + 1
    got = TV.backtrace_walk_unpack8(
        TV.backtrace_walk_packed8(btt, it, jt, st, kmax).numpy(), kmax)
    for b in range(B):
        ref = JV.backtrace(btj[b], int(ij[b]), int(jj[b]))
        for x, y in zip(got(b), ref):
            np.testing.assert_array_equal(x, y)


def test_k2_lq_true_excludes_padding_rows():
    Lq, Lt, B = 25, 21, 3
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(Lq, Lt, B, seed=6)
    ref = viterbi_backtrace_lanes(*_t(qp, qtr, tp, ttr, t_L), -0.03)
    qp_pad = np.zeros((32 + 2, 20), np.float32)
    qp_pad[: Lq + 2] = qp
    qtr_pad = np.full((32 + 2, 7), -np.finfo(np.float32).max, np.float32)
    qtr_pad[: Lq + 2] = qtr
    pad = viterbi_backtrace_lanes(*_t(qp_pad, qtr_pad, tp, ttr, t_L), -0.03,
                                  Lq_true=Lq)
    for a, b in zip(pad[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(pad[3][:, : Lq + 1].numpy(),
                                  ref[3].numpy())


@pytest.mark.parametrize("with_ss", [False, True])
@pytest.mark.parametrize("with_co", [False, True])
def test_k3_plain_matches_jax_rows_interpret(with_co, with_ss):
    """K3's plain version against the JAX kernel in interpret mode; with
    SS the port takes the table form (as K3 on the card) and the JAX
    kernel the dense matrix it defines (0 past each template's length)."""
    Lq, Lt, B = 37, 29, 4
    qp, qtr, tp, ttr, t_L, co, _ss = make_inputs(Lq, Lt, B, seed=7)
    co_arg = co if with_co else None
    jkw, tkw = {}, {}
    if with_ss:
        lut, qidx, tidx, dense = _ss_lut_inputs(Lq, Lt, B, seed=17)
        dense *= np.arange(Lt + 1)[None, None, :] <= t_L[:, None, None]
        jkw = dict(ss_score=dense)
        tkw = dict(ss_lut=torch.from_numpy(lut),
                   ss_qidx=torch.from_numpy(qidx),
                   ss_tidx=torch.from_numpy(tidx))
    sj, ij, jj, btj = [np.asarray(x) for x in jax_k3(
        qp, qtr, tp, ttr, co_arg, t_L, np.float32(-0.03), local=True,
        interpret=True, **jkw)]
    before = viterbi_batch_rows.launches
    qp_t, qtr_t, tp_t, ttr_t, tl_t = _args(qp, qtr, tp, ttr, t_L)
    st, it, jt, btt = viterbi_batch_rows(
        qp_t, qtr_t, tp_t, ttr_t, torch.from_numpy(co) if with_co else None,
        tl_t, -0.03, **tkw)
    assert viterbi_batch_rows.launches == before
    np.testing.assert_array_equal(btt.numpy(), btj)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(jt.numpy(), jj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6, atol=1e-4)


def test_k3_refuses_dense_ss_off_the_cpu_and_mixed_forms():
    """On a device tensor K3 takes the SS term as the table only; the
    dense matrix stays the JAX signature's CPU form."""
    qp, qtr, tp, ttr, t_L, _co, ss = make_inputs(25, 21, 3, seed=18)
    lut, qidx, tidx, _dense = _ss_lut_inputs(25, 21, 3, seed=19)
    args = _t(qp, qtr, tp, ttr, t_L)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="table"):
        viterbi_batch_rows(*meta[:4], None, meta[4], -0.03,
                           ss_score=torch.from_numpy(ss).to("meta"))
    table = dict(ss_lut=torch.from_numpy(lut), ss_qidx=torch.from_numpy(qidx),
                 ss_tidx=torch.from_numpy(tidx))
    with pytest.raises(ValueError, match="not both"):
        viterbi_batch_rows(*args[:4], None, args[4], -0.03,
                           ss_score=torch.from_numpy(ss), **table)
    with pytest.raises(ValueError, match="ss_qidx"):
        viterbi_batch_rows(*args[:4], None, args[4], -0.03,
                           ss_lut=table["ss_lut"])


def test_wrappers_reject_other_devices():
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(25, 21, 3, seed=8)
    args = _t(qp, qtr, tp, ttr, t_L)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        viterbi_score_lanes_fused(*meta, -0.03)
    with pytest.raises(ValueError):
        viterbi_score_lanes_fused(*args, -0.03, si_mode="split")


def _ss_lut_inputs(Lq, Lt, B, seed):
    """An S33-shaped table (4 x 11 x 4 x 11 floats) and offsets spanning
    it, the form build_ss_lut gives; plus the dense matrix they define
    (row 0 and column 0 zero)."""
    rng = np.random.default_rng(seed)
    lut = (rng.random(1936) * 0.6 - 0.3).astype(np.float32)
    qidx = (rng.integers(0, 44, Lq) * 44).astype(np.int32)
    tidx = rng.integers(0, 44, (B, Lt)).astype(np.int32)
    qidx[0], tidx[0, 0] = 0, 0
    qidx[-1], tidx[-1, -1] = 43 * 44, 43        # both ends of the table
    dense = np.zeros((B, Lq + 1, Lt + 1), np.float32)
    dense[:, 1:, 1:] = lut[qidx[None, :, None] + tidx[:, None, :]]
    return lut, qidx, tidx, dense


@pytest.mark.parametrize("shape", [(37, 29, 4), (21, 30, 3)])
@pytest.mark.parametrize("form", ["dense", "lut"])
def test_k6_plain_matches_jax_interpret(shape, form):
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(*shape, seed=11)
    lut, qidx, tidx, dense = _ss_lut_inputs(*shape, seed=12)
    if form == "dense":
        jkw = dict(ss_score=dense)
        tkw = dict(ss_score=torch.from_numpy(dense))
    else:
        jkw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
        tkw = dict(ss_lut=torch.from_numpy(lut),
                   ss_qidx=torch.from_numpy(qidx),
                   ss_tidx=torch.from_numpy(tidx))
    want = np.asarray(jax_k6(qp, qtr, tp, ttr, t_L, np.float32(-0.03),
                             si_dtype="float32", interpret=True, **jkw))
    before = viterbi_score_lanes.launches
    got = viterbi_score_lanes(*_args(qp, qtr, tp, ttr, t_L), -0.03, **tkw)
    assert viterbi_score_lanes.launches == before      # plain on the CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-4)


def test_k6_lut_equals_dense_and_no_ss_equals_k1_exact():
    shape = (40, 23, 5)
    qp, qtr, tp, ttr, t_L, _co, _ss = make_inputs(*shape, seed=13)
    lut, qidx, tidx, dense = _ss_lut_inputs(*shape, seed=14)
    args = _args(qp, qtr, tp, ttr, t_L)
    s_lut = viterbi_score_lanes(*args, -0.03, ss_lut=torch.from_numpy(lut),
                                ss_qidx=torch.from_numpy(qidx),
                                ss_tidx=torch.from_numpy(tidx))
    s_dense = viterbi_score_lanes(*args, -0.03,
                                  ss_score=torch.from_numpy(dense))
    np.testing.assert_array_equal(s_lut.numpy().view(np.int32),
                                  s_dense.numpy().view(np.int32))
    s_none = viterbi_score_lanes(*args, -0.03)
    s_k1 = viterbi_score_lanes_fused(*args, -0.03, si_mode="exact")
    np.testing.assert_array_equal(s_none.numpy().view(np.int32),
                                  s_k1.numpy().view(np.int32))
    assert not np.array_equal(s_lut.numpy(), s_none.numpy())


def test_k6_rejects_bfloat16_si_and_mixed_forms():
    qp, qtr, tp, ttr, t_L, _co, ss = make_inputs(25, 21, 3, seed=15)
    args = _t(qp, qtr, tp, ttr, t_L)
    with pytest.raises(ValueError, match="float32"):
        viterbi_score_lanes(*args, -0.03, si_dtype="bfloat16")
    lut = torch.zeros(1936)
    with pytest.raises(ValueError):
        viterbi_score_lanes(*args, -0.03, ss_score=torch.from_numpy(ss),
                            ss_lut=lut)
    with pytest.raises(ValueError):
        viterbi_score_lanes(*args, -0.03, ss_lut=lut)
