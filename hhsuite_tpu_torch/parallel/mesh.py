"""Multi-device execution: template-axis sharding over a device mesh.

The counterpart of the JAX package's ``parallel/mesh.py`` (itself the
replacement of the reference's scale-out programs, src/hhblits_mpi.cpp:
160-228 and the multi-``-d`` database loop, src/hhblits.cpp:1165-1175):
a template batch — the axis the reference fills with SIMD lanes and
OpenMP threads — is split over the devices of a mesh.  Each device runs
its shard through the same kernels the single-device path picks for the
batch, and only scores and packed walk payloads come back.  Templates
are independent of their batchmates in every kernel, so the gathered
result is the single-device result bit for bit: the merged-hitlist
semantics of the reference's ffmerge_splits (src/hhblits_mpi.cpp:83-93)
without a filesystem round trip.

A mesh is an ordered list of ``torch.device``s, which may name one
device more than once (``["cpu"] * 4`` in the CPU tests, ``[cuda:0,
cuda:0]`` on one card): shards then run one after another on that
device, which exercises the sharding without a second card.  Shards on
separate cards overlap: every shard is launched, under
``torch.cuda.device(d)``, before any result is gathered.

The mesh is process-wide state set by the CLI (``-mesh N``, or every
visible card when there is more than one) or thread-locally by
:func:`use_mesh` (the batch search's worker threads, the tests); the
search consults :func:`get_mesh` at each batched kernel call.  With no
mesh, or a mesh of one device, every code path is the single-device one.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import on_card, resolve_device

_ACTIVE_MESH = None                  # process-wide default (CLI -mesh)
_TLS = threading.local()             # per-thread override (use_mesh)

FLT_MAX = float(np.finfo(np.float32).max)


class Mesh:
    """An ordered list of devices; a device may appear more than once."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None, device=None) -> Mesh:
    """A mesh over ``devices``: a list of devices or names (repeats
    allowed), or an int n — the first n visible cards, or the CPU n
    times when ``device`` (:func:`device.resolve_device`'s rule) is the
    CPU; None: every visible card.  Asking for more cards than there are
    gives all of them, as the JAX package's ``make_mesh`` does."""
    if devices is not None and not isinstance(devices, int):
        return Mesh(devices)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh(["cpu"] * max(1, devices or 1))
    count = torch.cuda.device_count()
    n = count if devices is None else max(1, min(devices, count))
    return Mesh([f"cuda:{k}" for k in range(n)])


def set_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    """The active mesh, or None when single-device execution applies.

    A thread-local mesh (:func:`use_mesh`) shadows the process default:
    the batch search gives each worker thread its own sub-mesh, so
    concurrent queries run on disjoint devices (the hhblits_omp axis)
    while each still shards its template batches over its sub-mesh (the
    hhblits_mpi/database axis)."""
    mesh = getattr(_TLS, "mesh", None)
    if mesh is None:
        mesh = _ACTIVE_MESH
    if mesh is not None and mesh.size > 1:
        return mesh
    return None


@contextmanager
def use_mesh(mesh):
    """Thread-locally activate a mesh (nestable, restored on exit)."""
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _TLS.mesh = prev


class _SingleDeviceMesh:
    """A sub-mesh of one device: shadows the process-wide mesh inside a
    worker thread that was given exactly one device, so that
    :func:`get_mesh` returns None there (the single-device path); the
    worker runs its queries with ``device=`` this mesh's device."""

    size = 1

    def __init__(self, device):
        self.devices = [torch.device(device)]


def split_mesh(mesh, n_groups: int) -> List:
    """Partition a mesh's devices into ``n_groups`` sub-meshes (the last
    takes the remainder).

    The reference runs one independent HHblits instance per OpenMP
    thread (src/hhblits_omp.cpp:122-164); here each worker thread gets
    len(devices) / n_groups devices as its own mesh, so queries run side
    by side on disjoint devices and template batches still shard within
    one.  A group of one device is a :class:`_SingleDeviceMesh`."""
    devs = list(mesh.devices)
    n_groups = max(1, min(n_groups, len(devs)))
    per = len(devs) // n_groups
    out = []
    for g in range(n_groups):
        sub = devs[g * per: (g + 1) * per]
        if g == n_groups - 1:
            sub = devs[g * per:]
        out.append(Mesh(sub) if len(sub) > 1 else _SingleDeviceMesh(sub[0]))
    return out


def auto_mesh(device=None):
    """A mesh over every visible card when there is more than one and
    the search runs on a card (the default: hhblits_omp/_mpi
    parallelism without flags); None otherwise."""
    if resolve_device(device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    return make_mesh(n, "cuda") if n > 1 else None


def _pad_leading(a: torch.Tensor, Bp: int, fill) -> torch.Tensor:
    B = a.shape[0]
    if B == Bp:
        return a
    pad = torch.full((Bp - B,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def sharded_template_call(fn: Callable, sharded_args: Sequence,
                          fills: Sequence, replicated_args: Sequence = ()):
    """Run ``fn(*replicated_args, *sharded_args)`` with the leading axis
    of every sharded tensor split over the active mesh's devices.

    The batch is padded to a multiple of the device count with
    ``fills[i]`` for sharded argument i (the values ``pack_templates``
    pads with, so padded lanes flow through the kernels like any other
    padded lane); a None argument stays None in every shard.  Shard k
    runs on device k under ``torch.cuda.device``, every shard is
    launched before any output is gathered, and the outputs (a tensor
    with the sharded leading axis) are concatenated on the first sharded
    argument's device and sliced back to the true batch size."""
    mesh = get_mesh()
    assert mesh is not None
    devs = mesh.devices
    nd = len(devs)
    home = sharded_args[0].device
    B = sharded_args[0].shape[0]
    Bp = -(-B // nd) * nd
    per = Bp // nd
    padded = [None if a is None else _pad_leading(a, Bp, f)
              for a, f in zip(sharded_args, fills)]
    outs = []
    for k, d in enumerate(devs):
        with on_card(d):
            rep = [a.to(d) if isinstance(a, torch.Tensor) else a
                   for a in replicated_args]
            shard = [None if a is None else a[k * per: (k + 1) * per].to(d)
                     for a in padded]
            outs.append(fn(*rep, *shard))
    return torch.cat([o.to(home) for o in outs])[:B]


def sharded_viterbi_backtrace(qp, qtr, tp, ttr, t_L, shift, kmax: int,
                              hot: bool, cell_off=None, ss_kw=None,
                              local: bool = True, Lq_true=None,
                              egq: float = 0.0, egt: float = 0.0):
    """The backtrace pass of one template batch, template-sharded: each
    shard runs :func:`search.viterbi_search.backtrace_batch` — the
    kernel the single-device path picks for the batch (``hot``: K2,
    else K3) and the walk W1 of its bt — on its own device, so bt never
    leaves it; returns the gathered (B, 12 + kmax) walk payload on the
    batch's device.  ``ss_kw``: K3's SS table (``ss_lut``, ``ss_qidx``
    replicated, ``ss_tidx`` sharded)."""
    from ..search.viterbi_search import backtrace_batch

    kw = dict(ss_kw or {})
    lut, qidx, tidx = (kw.get("ss_lut"), kw.get("ss_qidx"),
                       kw.get("ss_tidx"))

    def fn(qp_, qtr_, lut_, qidx_, tp_, ttr_, tl_, co_, tidx_):
        ss = ({} if lut_ is None
              else dict(ss_lut=lut_, ss_qidx=qidx_, ss_tidx=tidx_))
        return backtrace_batch(qp_, qtr_, tp_, ttr_, tl_, shift, kmax, hot,
                               cell_off=co_, ss_kw=ss, local=local,
                               Lq_true=Lq_true, egq=egq, egt=egt)

    return sharded_template_call(
        fn, sharded_args=(tp, ttr, t_L, cell_off, tidx),
        fills=(0.0, -FLT_MAX, 0, False, 0),
        replicated_args=(qp, qtr, lut, qidx))


def sharded_lanes_scores(qp, qtr, tp, ttr, t_L, shift, impl: str,
                         ss_kw=None):
    """The funnel's score-only sweep of one chunk, template-sharded:
    each shard runs :func:`search.viterbi_search.sweep_batch` (K6 with
    the SS table, else the ``impl`` kernel: K1 fast or exact, or K6
    without SS); returns the gathered (B,) scores."""
    from ..search.viterbi_search import sweep_batch

    kw = dict(ss_kw or {})
    lut, qidx, tidx = (kw.get("ss_lut"), kw.get("ss_qidx"),
                       kw.get("ss_tidx"))

    def fn(qp_, qtr_, lut_, qidx_, tp_, ttr_, tl_, tidx_):
        ss = ({} if lut_ is None
              else dict(ss_lut=lut_, ss_qidx=qidx_, ss_tidx=tidx_))
        return sweep_batch(qp_, qtr_, tp_, ttr_, tl_, shift, impl, ss)

    return sharded_template_call(
        fn, sharded_args=(tp, ttr, t_L, tidx),
        fills=(0.0, -FLT_MAX, 0, 0),
        replicated_args=(qp, qtr, lut, qidx))


def sharded_prefilter_scores(kernel, qc, pack, offsets, lengths, *scalars):
    """Prefilter stage 1 or 2 (``kernel``: K4 or K5 over the resident
    layout, ``kernel(qc, states, offsets, lengths, *scalars) -> (B,)
    int32``) with the database rows sharded over the mesh: the rows'
    ``offsets`` and ``lengths`` are split (padded with empty rows), the
    query table is replicated, and each device reads the states of its
    own copy of the resident pack (``pack.states_on(d)``, uploaded once
    per device) — the reference's OpenMP static chunks over database
    sequences (src/hhprefilter.cpp:466-536)."""
    def fn(qc_, off_, ln_):
        return kernel(qc_, pack.states_on(off_.device), off_, ln_, *scalars)

    return sharded_template_call(fn, sharded_args=(offsets, lengths),
                                 fills=(0, 0), replicated_args=(qc,))


def global_topk_scores(local_scores, k: int):
    """Global top-k of per-process candidate scores over every process
    of the ``torch.distributed`` group (the multi-host database-sharding
    reduction; the reference's nearest analogue is the filesystem merge
    ffmerge_splits, src/hhblits_mpi.cpp:83-93).

    Each process holds the scores of its database shard (any length).
    Each contributes its local top-k; one ``all_gather`` (Gloo on the
    CPU, NCCL on cards) replicates the candidates and the final top-k is
    computed identically everywhere.  Returns ``(scores, ranks,
    local_indices)`` of length ``min(k, total)``, identical on every
    process, ties broken by score desc, rank asc, local index asc.  With
    no process group, or a group of one, it is a host argsort."""
    import torch.distributed as dist

    local_scores = np.asarray(local_scores, np.float32)
    order = np.argsort(-local_scores, kind="stable")[:k]
    cand_s = local_scores[order]
    cand_i = order.astype(np.int32)
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return cand_s, np.zeros(len(order), np.int32), cand_i

    # pad every process's candidates to k so the shapes agree
    pad = k - len(order)
    if pad > 0:
        cand_s = np.concatenate([cand_s, np.full(pad, -np.inf, np.float32)])
        cand_i = np.concatenate([cand_i, np.full(pad, -1, np.int32)])
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    world = dist.get_world_size()
    s_loc = torch.from_numpy(cand_s).to(dev)
    i_loc = torch.from_numpy(cand_i).to(dev)
    all_s = [torch.empty_like(s_loc) for _ in range(world)]
    all_i = [torch.empty_like(i_loc) for _ in range(world)]
    dist.all_gather(all_s, s_loc)
    dist.all_gather(all_i, i_loc)
    flat_s = torch.cat(all_s).cpu().numpy()
    flat_i = torch.cat(all_i).cpu().numpy()
    flat_p = np.repeat(np.arange(world, dtype=np.int32), k)
    valid = flat_i >= 0
    flat_s, flat_i, flat_p = flat_s[valid], flat_i[valid], flat_p[valid]
    sel = np.lexsort((flat_i, flat_p, -flat_s))[:k]
    return flat_s[sel], flat_p[sel], flat_i[sel]
