"""``csrc/prefilter.cu`` compiled with g++ against the CPU stand-in for
the CUDA runtime (``tests/cuda_emu/cuda_runtime.h``, as
``test_torch_cuda_emulation.py`` compiles ``csrc/viterbi.cu``) and run on
the CPU through the port's own launch code (``ops/prefilter.py``).

The wavefront that both kernels share (group widths, passes, the pass
boundary through the scratch row, sequences of one warp ending at
different steps, the global-table route) is held int-identical to the
plain versions at each group width G = 8, 16, 32: K5 (with the F chain
across lanes and passes) to ``gapped_scores_plain`` at
``chip_smoke.k5_edge_shapes``, K4 to ``ungapped_scores_plain`` at
``chip_smoke.k4_edge_shapes`` (saturation at 255 - off across a pass
boundary among them) and at the plain-version tests' shapes.  Skips where
g++ is missing.
"""

import pytest
import torch

from chip_smoke import k4_edge_shapes, k5_edge_inputs, k5_edge_shapes
from hhsuite_tpu_torch.ops import prefilter as P
from test_torch_cuda_emulation import build_emulated
from test_torch_prefilter import SHAPES as PF_SHAPES
from test_torch_prefilter import make_inputs


@pytest.fixture(scope="module")
def pf_emu_lib(tmp_path_factory):
    return P.bind(build_emulated("prefilter", tmp_path_factory))


@pytest.fixture
def pf_emulated(pf_emu_lib, monkeypatch):
    """The launch code of ops/prefilter.py on CPU tensors, into the
    emulated library."""
    monkeypatch.setattr(P, "cuda_lib", lambda: pf_emu_lib)
    monkeypatch.setattr(P, "_require_cuda", lambda t: t.device)
    monkeypatch.setattr(P, "_stream", lambda dev: 0)


def _force_width(monkeypatch, G):
    geometry = P.pf_geometry
    monkeypatch.setattr(P, "pf_geometry",
                        lambda *a, **kw: geometry(*a, **kw, G=G))


# a stage's launch, plain version and launch counter
STAGES = {"K4": (P._launch_ungapped, P.ungapped_scores_plain,
                 P.ungapped_scores),
          "K5": (P._launch_gapped, P.gapped_scores_plain, P.gapped_scores)}
EDGES = ([("K5", c) for c in k5_edge_shapes()]
         + [("K4", c) for c in k4_edge_shapes()])


@pytest.mark.parametrize("stage,case", EDGES,
                         ids=lambda c: c if isinstance(c, str)
                         else f"G{c[1]}-{c[0]}")
def test_emulated_wavefront_int_identical(pf_emulated, monkeypatch, stage,
                                          case):
    tag, G, Lq, _Ld, B, _lens, args = case
    launch, plain, counter = STAGES[stage]
    _force_width(monkeypatch, G)
    tab, db, dl = (torch.from_numpy(x)
                   for x in k5_edge_inputs(case, seed=Lq + G))
    n = counter.launches
    got = launch(tab, *P._as_packed(db, dl), *args)
    assert counter.launches == n + 1
    want = plain(tab, db, dl, *args)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert torch.equal(got, want)
    if tag.startswith("row at 255"):
        assert int(got.max()) == 255 - args[-1]
    assert not got[dl == 0].any()          # an empty sequence scores 0


@pytest.mark.parametrize("shape", PF_SHAPES + [(1025, 40, 5, 8)])
def test_emulated_k4_int_identical(pf_emulated, shape):
    qc, db, dl = (torch.from_numpy(x) for x in make_inputs(*shape))
    got = P._launch_ungapped(qc, *P._as_packed(db, dl), 50)
    assert torch.equal(got, P.ungapped_scores_plain(qc, db, dl, 50))
