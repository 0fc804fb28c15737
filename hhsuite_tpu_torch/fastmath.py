"""Bit-faithful reimplementations of the reference's fast float math.

The reference scores depend on custom polynomial approximations of log2/2^x
(`src/util-inl.h:83-215`, `src/hhutil-inl.h:470-545`).  They are pure IEEE-754
float32 bit manipulation + polynomials, so they are portable: we reproduce
them exactly (same operation order, float32 arithmetic) in vectorized numpy
and in torch so that host- and device-side scores agree with the
reference to the last ulp wherever FMA contraction doesn't interfere
(torch runs each elementwise op as its own rounded f32 operation; the
CUDA kernels of this package are built with -fmad=false for the same
reason).

Functions
---------
flog2        scalar-path log2, 5th-order poly     (util-inl.h:83-93)
fast_log2    LUT+interp log2                      (util-inl.h:108-129)
log2f4       SIMD-path log2, minimax deg-4        (hhutil-inl.h:509-545)
fpow2        2^x, 4th-order poly                  (util-inl.h:190-215)
log2_quartic exponent-bit log2 + quartic correction  (funnel sweep only)
"""

from __future__ import annotations

import numpy as np

FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)
_FLT_MAX_EXP = 128
_FLT_MIN_EXP = -125


def _f32(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------- numpy ----

def flog2(x):
    """log2 via 5th-order polynomial on the mantissa (util-inl.h:83-93).

    Returns -128 for x <= 0.
    """
    x = _f32(x)
    bits = x.view(np.int32)
    e = (((bits & 0x7F800000) >> 23) - 0x7F).astype(np.float32)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(np.float32)
    y = m - np.float32(1.0)
    # the C literals are doubles, so the polynomial runs in f64 and is
    # truncated once by the final float store (util-inl.h:90-92)
    yd = y.astype(np.float64)
    p = 1.441740 + yd * (-0.7077702 + yd * (0.4123442
                                            + yd * (-0.1903190
                                                    + yd * 0.0440047)))
    r = (yd * p).astype(np.float32) + e
    return np.where(x <= 0, np.float32(-128.0), r)


def log2f4(x):
    """log2 via degree-4 minimax polynomial (hhutil-inl.h:509-545).

    No non-positive guard: matches the SIMD kernel (x>0 expected).
    """
    x = _f32(x)
    bits = x.view(np.int32)
    e = (((bits & 0x7F800000) >> 23) - 127).astype(np.float32)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(np.float32)
    # POLY3 Horner: c3*m^3 + c2*m^2 + c1*m + c0
    p = np.float32(-0.107254423828329604454)
    p = p * m + np.float32(0.688243882994381274313)
    p = p * m + np.float32(-1.75647175389045657003)
    p = p * m + np.float32(2.61761038894603480148)
    p = p * (m - np.float32(1.0))
    return p + e


_LG2_TAB = None
_LG2_DIFF = None


def _fast_log2_tables():
    global _LG2_TAB, _LG2_DIFF
    if _LG2_TAB is None:
        lg2 = np.zeros(1025, dtype=np.float32)
        diff = np.zeros(1025, dtype=np.float32)
        prev = np.float32(0.0)
        # identical loop to util-inl.h:114-123 (double intermediates,
        # float32 storage)
        for i in range(1, 1025):
            lg2[i] = np.float32(
                np.log(np.float64(np.float32(1024 + i))) * 1.442695041 - 10.0)
            diff[i - 1] = np.float32(
                np.float64(np.float32(lg2[i] - prev)) * 1.2352e-4)
            prev = lg2[i]
        _LG2_TAB, _LG2_DIFF = lg2, diff
    return _LG2_TAB, _LG2_DIFF


def fast_log2(x):
    """LUT-based log2 with linear interpolation (util-inl.h:108-129).

    Returns -100000 for x <= 0.
    """
    lg2, diff = _fast_log2_tables()
    x = _f32(x)
    bits = x.view(np.int32)
    a = (((bits & 0x7F800000) >> 23) - 0x7F).astype(np.float32)
    b = (bits & 0x007FE000) >> 13
    c = (bits & 0x00001FFF).astype(np.float32)
    r = a + lg2[b] + diff[b] * c
    return np.where(x <= 0, np.float32(-100000.0), r)


def fpow2(x):
    """2^x via truncation trick + 4th-order polynomial (util-inl.h:190-215)."""
    x = _f32(x)
    tx = (x - np.float32(0.5)) + np.float32(3 << 22)
    lx = tx.view(np.int32) - np.int32(0x4B400000)
    dx = x - lx.astype(np.float32)
    p = np.float32(0.0134929)
    p = dx * p + np.float32(0.0520749)
    p = dx * p + np.float32(0.241404)
    p = dx * p + np.float32(0.693019)
    r = dx * p + np.float32(1.0)
    bits = r.view(np.int32) + (lx << 23)
    r = bits.view(np.float32)
    r = np.where(x >= _FLT_MAX_EXP, FLT_MAX, r)
    r = np.where(x <= _FLT_MIN_EXP, np.float32(0.0), r)
    return r


def scalar_prod20(qi, tj):
    """20-component dot product with the reference's SSE summation tree
    (hhhit-inl.h:62-120): lane_l = ((p_l+p_{l+4}) + (p_{l+8}+p_{l+12}))
    + p_{l+16}; total = (lane3+lane2) + (lane1+lane0).  Vectorized over
    leading axes; float32 throughout.
    """
    p = (_f32(qi) * _f32(tj))
    lanes = [(p[..., l] + p[..., l + 4]) + (p[..., l + 8] + p[..., l + 12])
             for l in range(4)]
    lanes = [np.float32(lanes[l] + p[..., l + 16]) for l in range(4)]
    return np.float32((lanes[3] + lanes[2]) + (lanes[1] + lanes[0]))


# --------------------------------------------------------------- torch ----
# Same bit math on torch tensors (any device), via ``Tensor.view``
# reinterpretation.  Each line is one rounded f32 op, in the reference's
# operation order (the flog2 polynomial runs in f32 here, not f64).

def flog2_torch(x):
    """flog2 with the polynomial in f32 (as the device code runs it)."""
    import torch

    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    e = (((bits & 0x7F800000) >> 23) - 0x7F).to(torch.float32)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    y = m - 1.0
    p = torch.full_like(y, 0.0440047)
    p = y * p + np.float32(-0.1903190)
    p = y * p + np.float32(0.4123442)
    p = y * p + np.float32(-0.7077702)
    p = y * p + np.float32(1.441740)
    r = y * p + e
    return torch.where(x <= 0, torch.full_like(r, -128.0), r)


def log2f4_torch(x):
    """log2f4 (hhutil-inl.h:509-545); also the Viterbi Si log2."""
    import torch

    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    e = (((bits & 0x7F800000) >> 23) - 127).to(torch.float32)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    p = torch.full_like(m, np.float32(-0.107254423828329604454))
    p = p * m + np.float32(0.688243882994381274313)
    p = p * m + np.float32(-1.75647175389045657003)
    p = p * m + np.float32(2.61761038894603480148)
    p = p * (m - 1.0)
    return p + e


def log2_quartic_torch(x, sh):
    """Funnel-sweep log2 plus offset: ``log2(x) + 127 + sh`` from the
    exponent bits with a quartic mantissa correction (|err| <= 0.000146
    bit; the K1 ``fast`` mode).  ``sh`` is a python/np float32 scalar
    (the caller passes shift - 127)."""
    import torch

    bits = x.to(torch.float32).view(torch.int32)
    y0 = bits.to(torch.float32) * np.float32(1.1920929e-7)   # 127+e+f
    frac = y0 - torch.floor(y0)
    p = frac * np.float32(0.0803073) - np.float32(0.23669342)
    p = p * frac + np.float32(0.43807325)
    return (p * frac) * (1.0 - frac) + (y0 + np.float32(sh))


def fpow2_torch(x):
    import torch

    x = x.to(torch.float32)
    tx = (x - 0.5) + np.float32(3 << 22)
    lx = tx.view(torch.int32) - 0x4B400000
    dx = x - lx.to(torch.float32)
    p = torch.full_like(dx, np.float32(0.0134929))
    p = dx * p + np.float32(0.0520749)
    p = dx * p + np.float32(0.241404)
    p = dx * p + np.float32(0.693019)
    r = dx * p + np.float32(1.0)
    bits = r.view(torch.int32) + (lx << 23)
    r = bits.view(torch.float32)
    r = torch.where(x >= _FLT_MAX_EXP, torch.full_like(r, float(FLT_MAX)), r)
    r = torch.where(x <= _FLT_MIN_EXP, torch.zeros_like(r), r)
    return r


def scalar_prod20_torch(qi, tj):
    """:func:`scalar_prod20` on torch tensors: the reference's SSE
    summation tree over the last axis (length 20), broadcasting the
    leading axes.  The CUDA kernels sum in the same order."""
    p = qi * tj
    lanes = [((p[..., l] + p[..., l + 4]) + (p[..., l + 8] + p[..., l + 12]))
             + p[..., l + 16] for l in range(4)]
    return (lanes[3] + lanes[2]) + (lanes[1] + lanes[0])
