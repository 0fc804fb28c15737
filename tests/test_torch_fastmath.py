"""The port's torch fast-math twins against the JAX package's jnp
versions and the reference dumps (``fastmath_ref.txt``), bit for bit.

Inputs are the fixture grid plus seeded random floats; both packages get
the same numpy arrays.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhsuite_tpu import fastmath as jfm
from hhsuite_tpu.ops.viterbi import _log2f4 as jax_log2f4
from hhsuite_tpu_torch import fastmath as tfm

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "fastmath_ref.txt")


def _load():
    xs, l4, px, pv = [], [], [], []
    with open(FIX) as f:
        for line in f:
            t = line.split()
            if t[0] == "P":
                px.append(float.fromhex(t[1]))
                pv.append(float.fromhex(t[2]))
            else:
                xs.append(float.fromhex(t[0]))
                l4.append(float.fromhex(t[3]))
    as32 = lambda v: np.array(v, dtype=np.float32)  # noqa: E731
    return as32(xs), as32(l4), as32(px), as32(pv)


XS, LOG2F4, PX, FPOW2 = _load()
RNG_X = np.random.default_rng(7).lognormal(0.0, 6.0, 20000).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name,jax_fn,torch_fn,grid", [
    ("flog2", jfm.flog2_jnp, tfm.flog2_torch, "x"),
    ("log2f4", jfm.log2f4_jnp, tfm.log2f4_torch, "x"),
    ("viterbi_log2f4", jax_log2f4, tfm.log2f4_torch, "x"),
    ("fpow2", jfm.fpow2_jnp, tfm.fpow2_torch, "p"),
])
def test_torch_matches_jnp_bitwise(name, jax_fn, torch_fn, grid):
    x = np.concatenate([XS, RNG_X]) if grid == "x" else \
        np.concatenate([PX, np.random.default_rng(3).uniform(
            -140, 140, 5000).astype(np.float32)])
    want = np.asarray(jax_fn(jnp.asarray(x)))
    got = torch_fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_log2f4_matches_reference_dump():
    got = tfm.log2f4_torch(torch.from_numpy(XS)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(LOG2F4))


def test_fpow2_matches_reference_dump():
    got = tfm.fpow2_torch(torch.from_numpy(PX)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(FPOW2))


def test_scalar_prod20_sse_tree():
    rng = np.random.default_rng(11)
    q = rng.gamma(0.5, 1.0, (500, 20)).astype(np.float32)
    t = rng.gamma(0.5, 1.0, (500, 20)).astype(np.float32)
    want = jfm.scalar_prod20(q, t)
    got = tfm.scalar_prod20_torch(torch.from_numpy(q),
                                  torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_log2_quartic_formula_and_bound():
    """K1's fast log2: the TPU kernel's float expression
    (viterbi_lanes.py:483-489) evaluated in numpy f32, and its stated
    error bound against the exact log2."""
    x = np.concatenate([XS, RNG_X])
    x = x[(x > 1e-30) & (x < 1e30)]
    sh = np.float32(-0.03) - np.float32(127.0)
    y0 = x.view(np.int32).astype(np.float32) * np.float32(1.1920929e-7)
    frac = y0 - np.floor(y0)
    p = (np.float32(0.0803073) * frac - np.float32(0.23669342)) * frac \
        + np.float32(0.43807325)
    want = (p * frac) * (np.float32(1.0) - frac) + (y0 + sh)
    got = tfm.log2_quartic_torch(torch.from_numpy(x), sh).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    err = got.astype(np.float64) - (np.log2(x.astype(np.float64)) - 0.03)
    assert np.abs(err).max() < 0.000146 + 1e-4
