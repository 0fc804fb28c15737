"""Context-specific pseudocounts: CRF and context-library engines.

The reference supports two context engines selected by the extension of
``-contxt`` (hhfunc.cpp:205-246 InitializePseudocountsEngine):

* ``.crf``  — discriminative CRF states (Angermueller & Soeding 2012):
  src/cs/crf-inl.h (header), src/cs/crf_state-inl.h (state parsing +
  UpdatePseudocounts), src/cs/crf_pseudocounts-inl.h (posterior over
  states + pseudocount mixing).
* ``.lib``  — generative context library (Biegert & Soeding PNAS 2009):
  src/cs/library_pseudocounts-inl.h with window Emission
  (src/cs/emission.h:36-109, no background subtraction: sm == NULL)
  over a log-transformed ContextLibrary (cs::TransformToLog).

Both engines compute, per profile column i, a posterior over K context
states from the count-profile window around i, then mix the states'
pseudocount emission vectors.  The hot step is one
``(L, wlen*20) @ (wlen*20, K)`` matmul; kept in numpy float64 for exact
parity with the reference's double-precision loops (L*K ~ 2e6 MACs,
microseconds on host).  Admixture of the predicted pseudocounts into the
raw counts follows src/cs/pseudocounts-inl.h:59-112 (AdmixTo /
AdmixToTargetNeff) with the admixture functors of src/cs/pseudocounts.h
(Constant / CSBlast / HHsearch; defaults hhdecl.cpp:52-62).

The stock ``context_data.crf`` weights are not shipped (absent from the
reference checkout as well — only referenced by data/CMakeLists.txt), so
engines are constructed from a user-supplied ``-contxt`` file.  Without
one, ``get_context_engine`` probes ``$HHLIB/data/context_data.{crf,lib}``
(the scripts/HHPaths.pm convention) and, failing that, falls back to
substitution-matrix pseudocounts exactly as the reference's
``-nocontxt`` mode does — with a one-time warning, since the reference
binary defaults to CRF context pseudocounts (hhfunc.cpp:221-236).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .context_lib import ContextLibrary, emission_weights

_KSCALE = 1000.0

# src/cs/pseudocounts.h:119-122
_TN_PARAM_MIN = 0.0
_TN_PARAM_MAX = 1.0
_TN_PARAM_INIT = 0.5
_TN_EPS = 0.01


# ---------------------------------------------------------------------------
# admixture functors (src/cs/pseudocounts.h:52-115)
# ---------------------------------------------------------------------------

@dataclass
class ConstantAdmix:
    pca: float

    def __call__(self, neff):
        return np.full_like(np.asarray(neff, np.float64), self.pca)


@dataclass
class CSBlastAdmix:
    pca: float
    pcb: float

    def __call__(self, neff):
        return np.minimum(
            1.0, self.pca * (self.pcb + 1.0)
            / (self.pcb + np.asarray(neff, np.float64)))


@dataclass
class HHsearchAdmix:
    pca: float
    pcb: float
    pcc: float = 1.0

    def __call__(self, neff):
        neff = np.asarray(neff, np.float64)
        if self.pcc == 1.0:
            return np.minimum(1.0, self.pca / (1.0 + neff / self.pcb))
        return np.minimum(
            1.0, self.pca / (1.0 + (neff / self.pcb) ** self.pcc))


def make_admix(mode: int, pca: float, pcb: float, pcc: float = 1.0):
    """Pseudocounts::CreateAdmix (src/hhdecl.h:115-131)."""
    if mode == 1:
        return ConstantAdmix(pca)
    if mode == 2:
        return HHsearchAdmix(pca, pcb, pcc)
    if mode == 3:
        return CSBlastAdmix(pca, pcb)
    raise ValueError(f"unknown admix mode {mode}")


# ---------------------------------------------------------------------------
# CRF model (src/cs/crf-inl.h, crf_state-inl.h)
# ---------------------------------------------------------------------------

@dataclass
class Crf:
    bias: np.ndarray      # (K,) float64
    weights: np.ndarray   # (K, wlen, 20) float64 context weights
    pc: np.ndarray        # (K, 20) float64 linear pseudocount emissions

    @property
    def size(self):
        return self.bias.shape[0]

    @property
    def wlen(self):
        return self.weights.shape[1]

    @property
    def center(self):
        return (self.wlen - 1) // 2

    @classmethod
    def from_text(cls, text: str) -> "Crf":
        """Crf::Read + CrfState::Read (src/cs/crf-inl.h:36-59,
        src/cs/crf_state-inl.h:30-77)."""
        lines = iter(text.splitlines())
        if not next(lines).startswith("CRF"):
            raise ValueError("stream does not start with 'CRF'")
        K = wlen = None
        for line in lines:
            if line.startswith("SIZE"):
                K = int(line.split()[1])
            elif line.startswith("LENG"):
                wlen = int(line.split()[1])
                break
        if K is None or wlen is None:
            raise ValueError("missing CRF SIZE/LENG header")

        def vals20(tokens):
            return np.array([-np.inf if t == "*" else float(t)
                             for t in tokens[:20]], np.float64) / _KSCALE

        bias = np.zeros(K, np.float64)
        weights = np.zeros((K, wlen, 20), np.float64)
        pcw = np.zeros((K, 20), np.float64)
        k = -1
        for line in lines:
            if line.startswith("CrfState"):
                k += 1
            elif line.startswith("BIAS"):
                bias[k] = float(line.split()[1])
            elif line.startswith("PC\t") or line.startswith("PC "):
                pcw[k] = vals20(line.split()[1:])
            elif line and line[0].isdigit():
                t = line.split()
                weights[k, int(t[0]) - 1] = vals20(t[1:])
        if k != K - 1:
            raise ValueError(f"CRF should have {K} states, got {k + 1}")

        # UpdatePseudocounts (src/cs/crf_state-inl.h:133-157):
        # pc = DBL_MIN + softmax(pc_weights)
        m = pcw.max(axis=1, keepdims=True)
        e = np.exp(pcw - m)
        pc = np.finfo(np.float64).tiny + e / e.sum(axis=1, keepdims=True)
        return cls(bias=bias, weights=weights, pc=pc)

    @classmethod
    def from_file(cls, path: str) -> "Crf":
        with open(path) as f:
            return cls.from_text(f.read())


def _window_stack(counts: np.ndarray, wlen: int) -> np.ndarray:
    """(L, 20) counts -> (L, wlen*20) zero-padded context windows.

    Zero padding reproduces the reference's beg/end clamping
    (src/cs/crf_state-inl.h:ContextScore): out-of-range window positions
    contribute nothing.
    """
    L = counts.shape[0]
    c = (wlen - 1) // 2
    pad = np.zeros((L + wlen - 1, 20), np.float64)
    pad[c:c + L] = counts
    idx = np.arange(L)[:, None] + np.arange(wlen)[None, :]
    return pad[idx].reshape(L, wlen * 20)


def _softmax_rows(act: np.ndarray) -> np.ndarray:
    m = act.max(axis=1, keepdims=True)
    e = np.exp(act - m)
    return e / e.sum(axis=1, keepdims=True)


class CrfPseudocounts:
    """src/cs/crf_pseudocounts-inl.h (AddToProfile == AddToSequence with
    one-hot counts)."""

    def __init__(self, crf: Crf):
        self.crf = crf
        self._wflat = crf.weights.reshape(crf.size, -1).T.copy()  # (w*20, K)

    def predict(self, counts: np.ndarray) -> np.ndarray:
        """Pseudocount profile P(a|X_i): (L, 20) -> (L, 20), rows sum 1."""
        act = _window_stack(counts, self.crf.wlen) @ self._wflat
        pp = _softmax_rows(act + self.crf.bias[None, :])
        pc = pp @ self.crf.pc
        return pc / pc.sum(axis=1, keepdims=True)


class LibraryPseudocounts:
    """src/cs/library_pseudocounts-inl.h over a log-space library.

    weight_center/weight_decay are par.csw/par.csb (hhdecl.cpp: csw=1.6,
    csb=0.85); emission built without background subtraction.
    """

    def __init__(self, lib: ContextLibrary, weight_center: float = 1.6,
                 weight_decay: float = 0.85):
        self.lib = lib
        logprobs = np.log(lib.probs)                       # (K, wlen, 20)
        w = emission_weights(lib.wlen, weight_center, weight_decay)
        weighted = logprobs * w[None, :, None]
        self._wflat = weighted.reshape(lib.size, -1).T.copy()
        self._logprior = np.log(lib.priors)
        # ContextProfile::Read: pc = linear center-column probs
        # (src/cs/context_profile-inl.h:135-139)
        self._pc = lib.probs[:, (lib.wlen - 1) // 2, :].copy()

    def predict(self, counts: np.ndarray) -> np.ndarray:
        act = _window_stack(counts, self.lib.wlen) @ self._wflat
        pp = _softmax_rows(act + self._logprior[None, :])
        pc = pp @ self._pc
        return pc / pc.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# admixture application (src/cs/pseudocounts-inl.h:44-112)
# ---------------------------------------------------------------------------

def _admix_to(pred: np.ndarray, counts: np.ndarray, neff: np.ndarray,
              admix) -> np.ndarray:
    """AdmixTo(CountProfile): p = tau*pred + (1-tau)*counts/neff."""
    tau = admix(neff)[:, None]
    return tau * pred + (1.0 - tau) * counts / neff[:, None]


def _neff_of_profile(p: np.ndarray) -> float:
    """cs::Neff(Profile) = 2^(entropy/L) (src/cs/profile-inl.h:220-233)."""
    q = np.where(p > np.finfo(np.float32).tiny, p, 1.0)
    ent = -(np.where(p > np.finfo(np.float32).tiny, p, 0.0)
            * np.log2(q)).sum()
    L = p.shape[0]
    return float(2.0 ** (ent / L)) if L > 0 else 0.0


def add_to_profile(engine, counts: np.ndarray, neff: np.ndarray, admix,
                   target_neff: float = 0.0,
                   target_neff_delta: float = 0.01) -> np.ndarray:
    """Pseudocounts::AddTo(CountProfile) (src/cs/pseudocounts-inl.h:44-56).

    counts: (L, 20) f*Neff columns; neff: (L,) per-column Neff.
    """
    pred = engine.predict(counts)
    if target_neff >= 1.0:
        # AdmixToTargetNeff bisection on the functor's pca
        # (src/cs/pseudocounts-inl.h:79-112)
        lo, hi = _TN_PARAM_MIN, _TN_PARAM_MAX
        admix.pca = _TN_PARAM_INIT
        best = None
        while lo < _TN_PARAM_MAX - _TN_EPS and hi > _TN_PARAM_MIN + _TN_EPS:
            p = _admix_to(pred, counts, neff, admix)
            ne = _neff_of_profile(p)
            if abs(ne - target_neff) <= target_neff_delta:
                best = p
                break
            if ne < target_neff:
                lo = admix.pca
            else:
                hi = admix.pca
            admix.pca = 0.5 * (lo + hi)
        if best is not None:
            return best
        if lo > _TN_PARAM_MAX - _TN_EPS:
            admix.pca = _TN_PARAM_MAX
        elif hi < _TN_PARAM_MIN + _TN_EPS:
            admix.pca = _TN_PARAM_MIN
        return _admix_to(pred, counts, neff, admix)
    return _admix_to(pred, counts, neff, admix)


# ---------------------------------------------------------------------------
# engine facade used by the search layer
# ---------------------------------------------------------------------------

class ContextPseudocountsEngine:
    """InitializePseudocountsEngine (hhfunc.cpp:205-246) + the HMM hook
    AddContextSpecificPseudocounts (hhhmm.cpp:1820-1850)."""

    def __init__(self, par):
        path = par.clusterfile
        if not path:
            raise ValueError("no -contxt file; use nocontxt pseudocounts")
        try:
            if path.endswith(".crf"):
                self.engine = CrfPseudocounts(Crf.from_file(path))
            else:
                with open(path) as f:
                    lib = ContextLibrary.from_text(f.read())
                self.engine = LibraryPseudocounts(lib, par.csw, par.csb)
        except OSError as e:
            # InitializePseudocountsEngine error path (hhfunc.cpp:214-218)
            raise SystemExit(
                f"Error: could not open file '{path}': {e.strerror}")
        self.hhm_admix = make_admix(par.pc_hhm_context_mode,
                                    par.pc_hhm_context_a,
                                    par.pc_hhm_context_b,
                                    par.pc_hhm_context_c)
        self.hhm_target_neff = par.pc_hhm_context_target_neff
        self.pre_admix = make_admix(par.pc_prefilter_context_mode,
                                    par.pc_prefilter_context_a,
                                    par.pc_prefilter_context_b,
                                    par.pc_prefilter_context_c)
        self.pre_target_neff = par.pc_prefilter_context_target_neff

    def _add(self, q, admix, target_neff):
        """HMM::AddContextSpecificPseudocounts + fillCountProfile
        (hhhmm.cpp:1820-1850): counts = f*Neff_M, result into p[1..L]."""
        if q.has_pseudocounts:
            q.p[1:q.L + 1, :20] = q.f[1:q.L + 1, :20]
            return
        neff = q.Neff_M[1:q.L + 1].astype(np.float64)
        counts = (q.f[1:q.L + 1, :20].astype(np.float64)
                  * neff[:, None])
        p = add_to_profile(self.engine, counts, neff, admix, target_neff)
        q.p[1:q.L + 1, :20] = p.astype(np.float32)

    def add_context_pseudocounts_hhm(self, q):
        self._add(q, self.hhm_admix, self.hhm_target_neff)

    def add_context_pseudocounts_prefilter(self, q):
        self._add(q, self.pre_admix, self.pre_target_neff)


_engine_cache = {}
_warned_no_context = False


def discover_context_file():
    """Probe for an installed context_data file like the reference's
    scripts do via $HHLIB (scripts/HHPaths.pm reads HHLIB and resolves
    data/context_data.crf).  Returns a path or None.  Checked locations,
    in order: $HHLIB/data/context_data.{crf,lib}, then
    $HHSUITE_TPU_DATA/context_data.{crf,lib}."""
    import os

    roots = []
    hhlib = os.environ.get("HHLIB")
    if hhlib:
        roots.append(os.path.join(hhlib, "data"))
    extra = os.environ.get("HHSUITE_TPU_DATA")
    if extra:
        roots.append(extra)
    for root in roots:
        for name in ("context_data.crf", "context_data.lib"):
            path = os.path.join(root, name)
            if os.path.isfile(path):
                return path
    return None


def get_context_engine(par):
    """Cached engine lookup for the search drivers.

    The reference defaults to CRF context pseudocounts built from an
    embedded context_data.crf (hhfunc.cpp:221-236); that data file is
    not shipped here, so without ``-contxt`` we (a) probe a standard
    HH-suite install via $HHLIB (discover_context_file), and (b) if
    nothing is found, fall back to substitution-matrix pseudocounts
    (``-nocontxt`` semantics) with a loud one-time warning.  Explicit
    ``-nocontxt`` suppresses both.  The cached engine keeps its
    admixture functors across queries, matching the reference's
    long-lived Admix objects (mutated in place by AdmixToTargetNeff).
    """
    global _warned_no_context
    if par.nocontxt:
        return None
    if not par.clusterfile:
        found = discover_context_file()
        if found:
            from .. import log

            par.clusterfile = found
            log.info(f"Using context file {found} (discovered via "
                     "HHLIB) for context-specific pseudocounts")
        else:
            if not _warned_no_context:
                from .. import log

                log.warning(
                    "No context file: falling back to substitution-"
                    "matrix pseudocounts (-nocontxt semantics). The "
                    "reference hh-suite defaults to CRF context "
                    "pseudocounts (hhfunc.cpp:221-236); pass -contxt "
                    "<context_data.crf> or set HHLIB to a standard "
                    "HH-suite install to match its default output.")
                _warned_no_context = True
            return None
    key = (par.clusterfile, par.csw, par.csb,
           par.pc_hhm_context_mode, par.pc_hhm_context_a,
           par.pc_hhm_context_b, par.pc_hhm_context_c,
           par.pc_hhm_context_target_neff,
           par.pc_prefilter_context_mode, par.pc_prefilter_context_a,
           par.pc_prefilter_context_b, par.pc_prefilter_context_c,
           par.pc_prefilter_context_target_neff)
    eng = _engine_cache.get(key)
    if eng is None:
        eng = _engine_cache[key] = ContextPseudocountsEngine(par)
    return eng
