"""The port's plain Viterbi (``hhsuite_tpu_torch.ops.viterbi``) against the
JAX package's ``ops.viterbi`` on the same numpy inputs.

Backtrace bytes, end cells and device-walk payloads must be identical;
scores agree within rtol 1e-6 / atol 1e-4 because XLA's einsum sums the
20-term profile dot in another order than the port's SSE tree
(hhsuite_tpu/ops/viterbi.py:14-15).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhsuite_tpu.ops import viterbi as JV
from hhsuite_tpu_torch.ops import viterbi as TV

FLT_MAX = float(np.finfo(np.float32).max)
SHAPES = [(37, 29, 4), (25, 21, 3), (40, 23, 5)]


def make_inputs(Lq, Lt, B, seed=0):
    """Profile-like query/template arrays in the JAX package's layout."""
    rng = np.random.default_rng(seed)

    def prof(n):
        p = rng.gamma(0.6, 1.0, (n, 20)).astype(np.float32) + 0.01
        return p / p.mean(axis=1, keepdims=True)

    def trans(n):
        return np.log2(rng.random((n, 7)) * 0.9 + 0.05).astype(np.float32)

    qp, qtr = prof(Lq + 2), trans(Lq + 2)
    t_L = rng.integers(max(1, Lt // 2), Lt + 1, B).astype(np.int32)
    t_L[0] = Lt
    tp = np.zeros((B, Lt + 2, 20), np.float32)
    ttr = np.full((B, Lt + 2, 7), -FLT_MAX, np.float32)
    for b in range(B):
        L = int(t_L[b])
        tp[b, : L + 1] = prof(L + 1)
        ttr[b, : L + 1] = trans(L + 1)
    co = rng.random((B, Lq + 1, Lt + 1)) < 0.08
    ss = (rng.random((B, Lq + 1, Lt + 1)) - 0.5).astype(np.float32)
    return qp, qtr, tp, ttr, t_L, co, ss


def run_both(Lq, Lt, B, local, use_co, use_ss, seed=0):
    qp, qtr, tp, ttr, t_L, co, ss = make_inputs(Lq, Lt, B, seed)
    j = JV.viterbi_batch(qp, qtr, tp, ttr,
                         co if use_co else np.zeros_like(co), t_L, -0.03,
                         0.0, 0.0, 0.0, ss_score=ss if use_ss else None,
                         local=local)
    t = TV.viterbi_batch(
        torch.from_numpy(qp), torch.from_numpy(qtr), torch.from_numpy(tp),
        torch.from_numpy(ttr), torch.from_numpy(co) if use_co else None,
        torch.from_numpy(t_L), -0.03,
        ss_score=torch.from_numpy(ss) if use_ss else None, local=local)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("local,use_co,use_ss", [
    (True, False, False), (True, True, False), (False, False, False),
    (False, True, False), (True, False, True)])
def test_viterbi_batch_matches_jax(shape, local, use_co, use_ss):
    (sj, ij, jj, btj), (st, it, jt, btt) = run_both(*shape, local, use_co,
                                                    use_ss)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(jt, jj)
    np.testing.assert_array_equal(btt, btj)
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_device_walk_payload_matches_jax(shape):
    Lq, Lt, B = shape
    (sj, ij, jj, btj), _ = run_both(Lq, Lt, B, True, True, False, seed=4)
    kmax = Lq + Lt + 1
    want = np.asarray(JV._backtrace_walk_packed8(
        jnp.asarray(btj), jnp.asarray(ij), jnp.asarray(jj), jnp.asarray(sj),
        kmax=kmax))
    got = TV.backtrace_walk_packed8_plain(
        torch.from_numpy(btj.copy()), torch.from_numpy(ij.copy()),
        torch.from_numpy(jj.copy()), torch.from_numpy(sj.copy()),
        kmax).numpy()
    np.testing.assert_array_equal(got, want)
    # the host decode of the payload is the scalar backtrace's path
    unpack = TV.backtrace_walk_unpack8(got, kmax)
    for b in range(B):
        ref = TV.backtrace(btj[b], int(ij[b]), int(jj[b]))
        for x, y in zip(unpack(b), ref):
            np.testing.assert_array_equal(x, y)


def test_walk_reads_lanes_last_view():
    """The kernels hand bt back as a permuted view; the walk must give
    the same payload on it as on contiguous storage."""
    (sj, ij, jj, btj), _ = run_both(25, 21, 3, True, False, False, seed=2)
    view = torch.from_numpy(np.ascontiguousarray(
        btj.transpose(1, 2, 0))).permute(2, 0, 1)
    args = [torch.from_numpy(x.copy()) for x in (ij, jj, sj)]
    a = TV.backtrace_walk_packed8_plain(view, *args, 47).numpy()
    b = TV.backtrace_walk_packed8_plain(torch.from_numpy(btj.copy()), *args,
                                        47).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_walk_reads_kernel_storage_view(shape):
    """The backtrace kernels return bt as a (B, Lq+1, Lt+1) view of
    [B][Lt+1][Wq] storage (ops.viterbi.bt_storage); the walk gives the
    same payload on it as on a contiguous copy."""
    Lq, Lt, B = shape
    (sj, ij, jj, btj), _ = run_both(Lq, Lt, B, True, True, False, seed=5)
    store, view = TV.bt_storage(B, Lq, Lt, torch.uint8, "cpu")
    store.fill_(0xAB)               # bytes outside the view never matter
    view.copy_(torch.from_numpy(btj.copy()))
    assert TV.bt_base(view).data_ptr() == store.data_ptr()
    assert view.stride() == ((Lt + 1) * TV.bt_col_bytes(Lq), 1,
                             TV.bt_col_bytes(Lq))
    kmax = Lq + Lt + 1
    args = [torch.from_numpy(x.copy()) for x in (ij, jj, sj)]
    a = TV.backtrace_walk_packed8_plain(view, *args, kmax).numpy()
    b = TV.backtrace_walk_packed8_plain(view.contiguous(), *args,
                                        kmax).numpy()
    np.testing.assert_array_equal(a, b)
    assert (a[:, 12:] != 0).any()


def test_walk_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """W1's wrapper on CPU tensors: the plain version's payload, no
    kernel launch."""
    (sj, ij, jj, btj), _ = run_both(40, 23, 5, True, True, False, seed=6)
    args = [torch.from_numpy(x.copy()) for x in (btj, ij, jj, sj)]
    monkeypatch.setattr(TV.backtrace_walk_packed8, "launches", 0)
    got = TV.backtrace_walk_packed8(*args, 64)
    assert TV.backtrace_walk_packed8.launches == 0
    assert torch.equal(got, TV.backtrace_walk_packed8_plain(*args, 64))


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("Li,Wj", [(33, 27), (9, 130)])
def test_exclusion_mask_device_matches_jax(P, Li, Wj):
    """The device-built mask equals the JAX package's and lies in the
    backtrace kernels' storage, so K3 reads it without a copy."""
    rng = np.random.default_rng(P)
    B = 4
    lo_c = rng.integers(0, Li, (B, P, Wj)).astype(np.int16)
    hi_c = (lo_c + rng.integers(-3, 12, (B, P, Wj))).astype(np.int16)
    lo_r = rng.integers(0, Wj, (B, P, Li)).astype(np.int16)
    hi_r = (lo_r + rng.integers(-3, 12, (B, P, Li))).astype(np.int16)
    want = np.asarray(JV.exclusion_mask_device(
        *(jnp.asarray(x) for x in (lo_c, hi_c, lo_r, hi_r))))
    got = TV.exclusion_mask_device(
        *(torch.from_numpy(x) for x in (lo_c, hi_c, lo_r, hi_r)))
    assert got.shape == (B, Li, Wj)
    assert TV.bt_base(got) is not None
    np.testing.assert_array_equal(got.numpy(), want)


def test_bt_base_only_takes_kernel_storage():
    x = torch.zeros((3, 10, 8), dtype=torch.bool)
    assert TV.bt_base(x) is None
    assert TV.bt_base(x.permute(0, 2, 1)) is None
    store, view = TV.bt_storage(3, 9, 7, torch.bool, "cpu", zero=True)
    assert view.shape == (3, 10, 8)
    assert TV.bt_base(view).shape == store.shape
