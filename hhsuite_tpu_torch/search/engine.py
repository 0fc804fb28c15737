"""Search engines: hhalign (pairwise) and hhsearch (database, no prefilter);
hhblits (prefilter, iterations) is in :mod:`search.hhblits`.

Entry points take ``device=`` (default: the CUDA card; ``"cpu"`` runs
every kernel's plain PyTorch version) and raise when the card is asked
for and absent.

Orchestration parity: HHalign::run (src/hhalign.cpp:590-676), HHsearch =
HHblits engine with prefilter=false, num_rounds=1 (src/hhsearch.cpp:19-26,
src/hhblits.cpp:1065-1414), perform_realign (src/hhblits.cpp:973-1063) and
PosteriorDecoderRunner grouping (src/hhposteriordecoderrunner.cpp:43-119).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import MINCOLS_REALIGN, Parameters
from ..core.hit import Hit, HitList
from ..core.hmm import HMM
from ..device import resolve_device
from ..io.ffindex import FFindexDatabase
from ..io.hhm import read_hhm
from ..matrices import (SecStrucMatrices, SubstitutionMatrix,
                        get_ss_matrices, get_substitution_matrix)
from ..profiling import annotate, gc_paused_fn, held, request, stage_add
from .posterior import (MACBacktraceResult, PosteriorDecoder,
                        RealignMaskSpec, build_realign_cell_off,
                        prepare_query_transitions,
                        prepare_template_transitions)
from .query import (finish_template_hmm, prepare_query_hmm,
                    prepare_template_hmm, read_query_text)
from .viterbi_search import promote_light_hits, viterbi_search


_DB_CACHE: Dict[str, "HHDatabase"] = {}
_DB_CACHE_LOCK = threading.Lock()


def get_database(base: str) -> "HHDatabase":
    """Process-level HHDatabase cache: the batch search and long-lived
    servers reuse one instance per base path, so the parsed templates
    and the resident template and cs219 packs stay warm across queries
    (the reference's hhblits_omp keeps its database open for the whole
    run, src/hhblits_omp.cpp:96-120).  The instance's caches grow under
    its :func:`db_lock` over immutable files, so worker threads share
    it."""
    with held(_DB_CACHE_LOCK):
        db = _DB_CACHE.get(base)
        if db is None:
            db = _DB_CACHE[base] = HHDatabase(base)
        return db


def db_lock(db) -> threading.RLock:
    """The lock that guards ``db``'s shared device caches (the resident
    template packs, the cs219 packs) against concurrent queries."""
    return db.__dict__.setdefault("_lock", threading.RLock())


def _fast_copy_hmm(t: HMM) -> HMM:
    """Cache hand-out copy: shallow-copy the HMM shell and privatize
    exactly the arrays the downstream pipeline mutates in place —
    ``p`` (include_null_model's odds division, hhhmm.cpp:2059-2144)
    and ``tr`` (log2lin + realign boundary overrides).  Every other
    field (f, g, seq, ss_*, Neff_*) is read-only past this point, so
    sharing them with the cached instance is safe and ~10x cheaper
    than a deepcopy per template per query."""
    import copy

    c = copy.copy(t)
    c.p = t.p.copy()
    c.tr = t.tr.copy()
    return c


class HHDatabase:
    """Multi-file database <base>_{cs219,a3m,hhm}.ff{data,index}
    (src/hhdatabase.cpp:64-130)."""

    def __init__(self, base: str):
        self.base = base
        self.cs219 = self._open(base + "_cs219")
        self.a3m = self._open(base + "_a3m")
        self.hhm = self._open(base + "_hhm")
        # compressed MSA database (checkAndBuildCompressedDatabase,
        # hhdatabase.cpp:238-298): requires ca3m + sequence + header
        self.ca3m = self._open(base + "_ca3m")
        self.sequence = self._open(base + "_sequence")
        self.header = self._open(base + "_header")
        self.use_compressed = (self.ca3m is not None
                               and self.sequence is not None
                               and self.header is not None)
        if self.cs219 is None:
            raise FileNotFoundError(f"no cs219 database at {base}_cs219")

    @staticmethod
    def _open(prefix: str) -> Optional[FFindexDatabase]:
        if os.path.exists(prefix + ".ffdata") and \
                os.path.exists(prefix + ".ffindex"):
            return FFindexDatabase(prefix + ".ffdata", prefix + ".ffindex")
        return None

    def size(self) -> int:
        return len(self.cs219)

    def init_no_prefilter(self) -> List[Tuple[str, int]]:
        """All entries with sequence lengths, in cs219 index order
        (Prefilter::init_no_prefiltering)."""
        return [(e.name, e.length - 1) for e in self.cs219.entries]

    # parsed-HMM cache: parsing a template HHM/a3m costs ~10-50 ms of
    # host time and the same entry is re-read by the realign pass and
    # by every hhblits round; entries are cached PRE-pseudocounts and
    # copied on return because prepare_template_hmm mutates in
    # place (getTemplateHMM re-reads from disk each time instead,
    # hhdatabase.cpp:300-455).  Capacity must cover the prefilter
    # survivor set (maxfilt=20000 default) or large queries thrash:
    # ~160 KB/cached HMM at L=300 -> ~6 GB worst case, well inside the
    # target hosts' RAM.
    _HMM_CACHE_MAX = 40000

    # (concurrent queries share the cache: a dict's get and set are
    # atomic, two threads that parse one entry at once put equal
    # values, and every hand-out is a per-call copy)
    def _hmm_cache_get(self, key):
        return self.__dict__.setdefault("_hmm_cache", {}).get(key)

    def _hmm_cache_put(self, key, value):
        cache = self.__dict__.setdefault("_hmm_cache", {})
        if len(cache) < self._HMM_CACHE_MAX:
            cache[key] = value

    def _parse_cache_key(self, name: str, par: Parameters,
                         use_global_weights: int):
        if self.hhm is not None and name in self.hhm:
            # the hhm branch ignores the MSA->HMM knobs (read_hhm takes
            # only nseqdis/maxres), so don't let them split the cache —
            # the realign pass calls with use_global_weights=par.wg
            return (name, "hhm", par.nseqdis, par.maxres)
        return (name, use_global_weights, par.nseqdis, par.maxres,
                par.max_seqid_db, par.coverage_db, par.qid_db,
                par.qsc_db, par.Ndiff_db, par.max_seqid, par.coverage,
                par.qid, par.qsc, par.Ndiff, par.M_template, par.Mgaps,
                par.mark, par.cons, par.showcons, par.maxseq)

    def get_template_hmm(self, name: str, par: Parameters,
                         mats: SubstitutionMatrix,
                         use_global_weights: int = 1) -> Tuple[HMM, int]:
        """getTemplateHMM (hhdatabase.cpp:300-455): prefer hhm, then
        compressed a3m, then plain a3m."""
        key = self._parse_cache_key(name, par, use_global_weights)
        hit = self._hmm_cache_get(key)
        if hit is not None:
            return _fast_copy_hmm(hit[0]), hit[1]
        t, fmt = self._load_template_hmm(name, par, mats,
                                         use_global_weights)
        self._hmm_cache_put(key, (t, fmt))
        return _fast_copy_hmm(t), fmt

    def _prepared_cache_entry(self, name: str, par: Parameters,
                              mats: SubstitutionMatrix,
                              use_global_weights: int = 1
                              ) -> Tuple[HMM, int]:
        """The cached prepared-template instance itself (NO hand-out
        copy) — read-only; used by the device-resident template pack."""
        from .query import template_pc_stage

        key = self._parse_cache_key(name, par, use_global_weights) + (
            "pc", par.gapb, par.gapd, par.gape, par.gapf, par.gapg,
            par.gaph, par.gapi, par.pc_hhm_nocontext_mode,
            par.pc_hhm_nocontext_a, par.pc_hhm_nocontext_b,
            par.pc_hhm_nocontext_c)
        hit = self._hmm_cache_get(key)
        if hit is None:
            # a cold build: its span and count give the ms a template
            with annotate("template_build"):
                t, fmt = self.get_template_hmm(name, par, mats,
                                               use_global_weights)
                template_pc_stage(par, t, mats, fmt)
            stage_add("template_builds")
            self._hmm_cache_put(key, (t, fmt))
            hit = (t, fmt)
        return hit

    def get_template_hmm_prepared(self, name: str, par: Parameters,
                                  mats: SubstitutionMatrix,
                                  use_global_weights: int = 1
                                  ) -> Tuple[HMM, int]:
        """Template with the query-independent pseudocount stage
        already applied (query.py:template_pc_stage) and cached;
        callers finish with finish_template_hmm(par, q, t, mats).
        Saves ~3 ms/template/query across rounds and batch queries."""
        t, fmt = self._prepared_cache_entry(name, par, mats,
                                            use_global_weights)
        return _fast_copy_hmm(t), fmt

    def get_template_hmm_search(self, name: str, par: Parameters,
                                mats: SubstitutionMatrix, q: HMM,
                                use_global_weights: int = 1
                                ) -> Tuple[HMM, int]:
        """Search-path handout: the cached prepared template with the
        null-model division (finish_template_hmm) fused into the copy —
        one out-of-place f32 divide replaces copy-then-divide-in-place,
        and ``tr`` is SHARED read-only (the Viterbi path never mutates
        transitions; the realign path must keep using
        get_template_hmm_prepared, which privatizes tr)."""
        import copy

        t, fmt = self._prepared_cache_entry(name, par, mats,
                                            use_global_weights)
        pb_t = getattr(t, "pb_hmmer", None)
        pnul32 = np.asarray(
            t.null_vector(q, par.columnscore,
                          pb_t if pb_t is not None else mats.pb),
            dtype=np.float32)
        c = copy.copy(t)
        if t.p.shape[0] == t.L + 2:
            # DEFER the odds division: the resident pack replays it on
            # the device and the native decode on the host
            # (vit_decode_rescore's pnul path), so most handouts never
            # need the divided array on host.  Host consumers
            # materialize it lazily via viterbi_search._template_p.
            c.p_divided = False
        else:                       # unusual buffer shape: exact path
            c.p = t.p.copy()
            c.p[: t.L + 2] = (c.p[: t.L + 2].astype(np.float32)
                              / pnul32[None, :])
        c.pnul_used = pnul32
        return c, fmt

    def _load_template_hmm(self, name: str, par: Parameters,
                           mats: SubstitutionMatrix,
                           use_global_weights: int = 1) -> Tuple[HMM, int]:
        if self.hhm is not None and name in self.hhm:
            text = self.hhm.read_text(name)
            return template_hmm_from_text(text, name, par, mats,
                                          use_global_weights)
        if self.use_compressed and name in self.ca3m:
            from ..core.profile import frequencies_and_transitions

            ali = self._read_compressed(name)
            ali.compress(M=par.M_template, Mgaps=par.Mgaps,
                         maxres=par.maxres, infile=name)
            ali.N_filtered = ali.filter(par.max_seqid_db, mats.S,
                                        par.coverage_db, par.qid_db,
                                        par.qsc_db, par.Ndiff_db)
            t = HMM()
            frequencies_and_transitions(ali, t, use_global_weights,
                                        par.mark, par.cons, par.showcons,
                                        mats.pb, mats.Sim)
            return t, 0
        if self.a3m is not None and name in self.a3m:
            text = self.a3m.read_text(name)
            return template_hmm_from_text(text, name, par, mats,
                                          use_global_weights)
        raise KeyError(f"entry {name} not in database {self.base}")

    def _read_compressed(self, name: str, mark: int = 0):
        from ..io.ca3m import read_compressed

        data = self.ca3m.read_bytes(name)
        return read_compressed(name, data, self.sequence, self.header,
                               mark=mark)

    def get_template_a3m_text(self, name: str) -> str:
        if self.use_compressed and name in self.ca3m:
            from ..io.ca3m import extract_a3m

            return extract_a3m(self.ca3m.read_bytes(name), self.sequence,
                               self.header)
        if self.a3m is not None and name in self.a3m:
            return self.a3m.read_text(name)
        raise KeyError(f"no a3m for entry {name}")

    def get_template_alignment(self, name: str, par: Parameters):
        """getTemplateA3M (hhdatabase.cpp:338-395): Alignment before
        Compress, via ReadCompressed for ca3m databases."""
        from ..core.alignment import Alignment

        if self.use_compressed and name in self.ca3m:
            return self._read_compressed(name, mark=par.mark)
        text = self.get_template_a3m_text(name)
        return Alignment.from_a3m_text(text, infile=name, mark=par.mark,
                                       maxseq=par.maxseq,
                                       nseqdis=par.nseqdis)


# device-memory budget of one database's resident template pack
PACK_BUDGET_GB = 40.0


def get_resident_pack(db, names: List[str], par: Parameters,
                      mats: SubstitutionMatrix, device,
                      use_global_weights: int = 1):
    """Per-database device-resident raw template pack on ``device``,
    incrementally extended with ``names`` (see
    viterbi_search.ResidentTemplatePack).  Rows hold the
    PRE-null-division prepared templates from the parse cache, so the
    pack is query-independent and survives across queries.

    Concurrent queries share it: the lookup, the budget check and the
    growth run under the database's :func:`db_lock` and the pack's own
    lock.  Under a device mesh the pack stays: each batch is gathered
    from it on ``device`` and its lanes are sharded from there (the
    JAX package packs per batch under a mesh instead; keeping the pack
    keeps the kernel and the query view the single-device path uses)."""
    from .viterbi_search import ResidentTemplatePack

    dev = resolve_device(device)
    key = (str(dev), use_global_weights, par.nseqdis, par.maxres,
           par.max_seqid_db, par.coverage_db, par.qid_db, par.qsc_db,
           par.Ndiff_db, par.max_seqid, par.coverage, par.qid, par.qsc,
           par.Ndiff, par.M_template, par.Mgaps, par.mark, par.cons,
           par.showcons, par.maxseq, par.gapb, par.gapd, par.gape,
           par.gapf, par.gapg, par.gaph, par.gapi,
           par.pc_hhm_nocontext_mode, par.pc_hhm_nocontext_a,
           par.pc_hhm_nocontext_b, par.pc_hhm_nocontext_c)
    with held(db_lock(db)):
        packs = db.__dict__.setdefault("_resident_packs", {})
        pack = packs.get(key)
        if pack is None:
            pack = packs[key] = ResidentTemplatePack(dev)
    budget = PACK_BUDGET_GB
    with held(pack.lock):
        items = []
        for name in names:
            if name not in pack.row_of:
                t, _fmt = db._prepared_cache_entry(name, par, mats,
                                                   use_global_weights)
                items.append((name, t))
        # device-memory budget: on very large databases (hundreds of
        # thousands of templates) a fully-resident pack would exceed
        # device memory; past the budget the search falls back to
        # per-batch host packing (slower, unbounded DB size).  The
        # estimate mirrors ensure()'s real allocation (pow2 capacity x
        # length buckets), and the PACK_DISABLED sentinel stops
        # viterbi_search from building its local fallback pack with the
        # same templates.
        est = pack.projected_bytes(items)
        if est > budget * 1e9:
            from .viterbi_search import PACK_DISABLED

            from .. import log as hhlog
            if not db.__dict__.get("_pack_budget_warned"):
                db.__dict__["_pack_budget_warned"] = True
                hhlog.warning(
                    f"template pack would need ~{est / 1e9:.1f} GB device "
                    f"memory (> {budget:g} GB); using per-batch template "
                    f"upload instead")
            return PACK_DISABLED
        if items:
            with annotate("template_pack_upload"):
                pack.ensure(items)
    return pack


class MultiHHDatabase:
    """Several -d databases presented as one (hhblits.cpp:1165-1175:
    the reference loops `for (size_t i = 0; i < dbs.size(); i++)` over
    its database vector for prefiltering and entry lookup; lookups here
    route by name, first database wins on collisions)."""

    def __init__(self, dbs: List["HHDatabase"]):
        assert dbs
        self.dbs = dbs
        self.base = ";".join(d.base for d in dbs)
        self.a3m = dbs[0].a3m            # truthiness probes only
        self.use_compressed = any(d.use_compressed for d in dbs)

        class _CS:
            """cs219 view over all member databases."""

            def __init__(self, dbs):
                self._dbs = dbs
                self.entries = [e for d in dbs for e in d.cs219.entries]
                self._route = {}
                for d in dbs:
                    for e in d.cs219.entries:
                        self._route.setdefault(e.name, d)

            def read_bytes(self, e):
                # entry objects remember their source index; route by
                # name (first database wins, like sequential -d search)
                return self._route[e.name].cs219.read_bytes(e.name)

        self.cs219 = _CS(dbs)
        self._route = self.cs219._route

    def size(self) -> int:
        return len(self.cs219.entries)

    def _db_for(self, name: str) -> "HHDatabase":
        db = self._route.get(name)
        if db is None:
            for d in self.dbs:
                if (d.hhm is not None and name in d.hhm) or \
                        (d.a3m is not None and name in d.a3m):
                    return d
            raise KeyError(f"entry {name} in no database of {self.base}")
        return db

    def init_no_prefilter(self):
        return [(e.name, e.length - 1) for e in self.cs219.entries]

    def get_template_hmm(self, name, par, mats, use_global_weights=1):
        return self._db_for(name).get_template_hmm(
            name, par, mats, use_global_weights)

    def get_template_hmm_prepared(self, name, par, mats,
                                  use_global_weights=1):
        return self._db_for(name).get_template_hmm_prepared(
            name, par, mats, use_global_weights)

    def _prepared_cache_entry(self, name, par, mats,
                              use_global_weights=1):
        return self._db_for(name)._prepared_cache_entry(
            name, par, mats, use_global_weights)

    def get_template_hmm_search(self, name, par, mats, q,
                                use_global_weights=1):
        return self._db_for(name).get_template_hmm_search(
            name, par, mats, q, use_global_weights)

    def get_template_a3m_text(self, name):
        return self._db_for(name).get_template_a3m_text(name)

    def get_template_alignment(self, name, par):
        return self._db_for(name).get_template_alignment(name, par)


def open_databases(bases: List[str]):
    """One HHDatabase, or a MultiHHDatabase for several -d arguments."""
    dbs = [HHDatabase(b) for b in bases]
    return dbs[0] if len(dbs) == 1 else MultiHHDatabase(dbs)


def template_hmm_from_text(text: str, name: str, par: Parameters,
                           mats: SubstitutionMatrix,
                           use_global_weights: int = 1) -> Tuple[HMM, int]:
    """HHEntry::getTemplateHMM file sniffing (hhdatabase.cpp:398-455)."""
    from ..core.alignment import Alignment
    from ..core.profile import frequencies_and_transitions

    stripped = text.lstrip()
    if stripped.startswith("HMMER3"):
        from ..io.hmmer import read_hmmer3

        t = read_hmmer3(text, showcons=par.showcons, pb=mats.pb,
                        filestr=name, maxres=par.maxres)
        return t, 1
    if stripped.startswith("HMMER"):
        from ..io.hmmer import read_hmmer2

        t = read_hmmer2(text, showcons=par.showcons, pb=mats.pb,
                        filestr=name, maxres=par.maxres)
        return t, 1
    if stripped.startswith("HH") or stripped.startswith("NAME"):
        t = read_hhm(text, nseqdis=par.nseqdis, maxres=par.maxres)
        base = os.path.basename(name)
        t.file = base.rsplit(".", 1)[0] if "." in base else base
        return t, 0
    if stripped.startswith("#") or stripped.startswith(">"):
        ali = Alignment.from_a3m_text(text, infile=name, mark=par.mark,
                                      maxseq=par.maxseq,
                                      nseqdis=par.nseqdis)
        ali.compress(M=par.M_template, Mgaps=par.Mgaps, maxres=par.maxres,
                     infile=name)
        ali.N_filtered = ali.filter(par.max_seqid, mats.S, par.coverage,
                                    par.qid, par.qsc, par.Ndiff)
        t = HMM()
        frequencies_and_transitions(ali, t, use_global_weights, par.mark,
                                    par.cons, par.showcons, mats.pb,
                                    mats.Sim)
        return t, 0
    raise ValueError(f"unrecognized template format in {name}")


def _use_device_realign(par: Parameters, selected, device) -> bool:
    """Whether ``perform_realign`` decodes on the card: the JAX package's
    rule (hhsuite_tpu/search/engine.py:_use_device_realign) with the card
    in place of the TPU.  True on a CUDA ``device`` without -omat and with
    at least 4 selected hits: the batched F/B/MAC kernels of
    ops/posterior_batch.py (R1-R4), level by level, in local and global
    (-glob) mode alike (global exits at each template's own last column,
    so the padded chunk decodes as the host does).  Otherwise the host
    decoder (native C++ forward/backward/MAC, the reference-exact path):
    on the CPU, for -omat (it needs the host decoder's sparse forward/
    backward products) and for fewer than 4 hits (hhalign's single hit
    among them).  Premerge always realigns one hit at a time on the host
    decoder, as in the JAX package.  (Tests monkeypatch this to force
    either path on the CPU.)"""
    return (getattr(device, "type", None) == "cuda"
            and not par.matrices_output_file and len(selected) >= 4)


def perform_realign(par: Parameters, q_realign: HMM, hitlist: HitList,
                    get_template, mats: SubstitutionMatrix,
                    ss: Optional[SecStrucMatrices],
                    min_col_realign: int = MINCOLS_REALIGN, device=None):
    """MAC realignment of selected hits (hhblits.cpp:973-1063 +
    hhposteriordecoderrunner.cpp:43-119), on ``device`` by the rule of
    :func:`_use_device_realign` (None: the host decoder).

    ``q_realign`` must be a fresh copy of the prepared query HMM (it is
    mutated: linear transitions + boundary overrides).
    ``get_template(entry)`` -> (HMM prepared with log transitions, format).
    """
    Lmaxmem = int((par.maxmem - 0.5) * 1024 ** 3
                  / (2 * 8 + 8) / max(q_realign.L, 1) / max(par.threads, 1))
    n_realign = 0
    selected: List[Hit] = []
    for hit in hitlist:
        if n_realign >= par.realign_max and n_realign >= max(par.B, par.Z):
            break
        if hit.Eval > par.e:
            if n_realign >= max(par.B, par.Z):
                continue
            if n_realign >= max(par.b, par.z) and hit.Probab < par.p:
                continue
            if n_realign >= max(par.b, par.z) and hit.Eval > par.E:
                continue
        if hit.L > Lmaxmem:
            continue
        if hit.light:
            continue  # funnel hit without a Viterbi path
        selected.append(hit)
        n_realign += 1

    from .. import log as hhlog
    hhlog.info(f"Realigning {len(selected)} HMM-HMM alignments using "
               f"Maximum Accuracy algorithm")

    q_realign.log2lin_transitions()
    prepare_query_transitions(q_realign)

    # group by template entry, sorted by irep (runner:52-64)
    groups: Dict[str, List[Hit]] = {}
    for hit in selected:
        groups.setdefault(str(hit.entry), []).append(hit)
    decoder = PosteriorDecoder(bool(par.loc), par.ssw_realign,
                               *( (ss.S73, ss.S37, ss.S33) if ss
                                  else (None, None, None)))

    if _use_device_realign(par, selected, device):
        # batched decoding (ops/posterior_batch.py): hits are processed
        # level-wise across templates — level k of a group sees the
        # MAC-path exclusions of levels < k, exactly like the sequential
        # per-group irep loop (posteriordecoderrunner.cpp)
        for group in groups.values():
            group.sort(key=lambda h: h.irep)
        tmpl: Dict[str, HMM] = {}
        with annotate("realign_template_prep"):
            for name, group in groups.items():
                t, _fmt = get_template(group[0].entry)
                t.log2lin_transitions()
                prepare_template_transitions(t)
                tmpl[name] = t
        to_excl: Dict[str, List[MACBacktraceResult]] = \
            {name: [] for name in groups}
        # the compact interval form (the corridor is built on the
        # device) unless -exclstr / -template_exclstr mask regions too
        use_spec = not (par.exclstr or par.template_exclstr)
        level = 0
        while True:
            items = []
            names = []
            for name, group in groups.items():
                if level < len(group):
                    hit = group[level]
                    t = tmpl[name]
                    if use_spec:
                        co = RealignMaskSpec(q_realign, t, hit,
                                             par.min_overlap,
                                             to_excl[name])
                    else:
                        co = build_realign_cell_off(
                            q_realign, t, hit, par.min_overlap,
                            to_excl[name], par.exclstr,
                            par.template_exclstr)
                    items.append((hit, t, co))
                    names.append(name)
            if not items:
                break
            with annotate("posterior_mac_realign_batch"):
                decoder.realign_batch_device(q_realign, items, par.shift,
                                             par.mact, par.corr, device)
            for name, (hit, _t, _co) in zip(names, items):
                to_excl[name].append(
                    MACBacktraceResult(hit.alt_i, hit.alt_j))
            level += 1
    else:
        for name, group in groups.items():
            group.sort(key=lambda h: h.irep)
            t, fmt = get_template(group[0].entry)
            t.log2lin_transitions()
            prepare_template_transitions(t)
            to_exclude: List[MACBacktraceResult] = []
            for hit in group:
                co = build_realign_cell_off(
                    q_realign, t, hit, par.min_overlap, to_exclude,
                    par.exclstr, par.template_exclstr)
                decoder.realign(q_realign, t, hit, co, par.shift,
                                par.mact, par.corr)
                to_exclude.append(
                    MACBacktraceResult(hit.alt_i, hit.alt_j))

    # delete hits whose realigned alignment became too short
    # (hhblits.cpp:1036-1062); note `continue` skips the length check
    # without counting the hit
    nhits = 0
    keep = []
    stopped = False
    for idx, hit in enumerate(hitlist):
        if stopped:
            keep.append(hit)
            continue
        if nhits > par.realign_max and nhits >= max(par.B, par.Z):
            stopped = True
            keep.append(hit)
            continue
        if hit.Eval > par.e:
            if nhits >= max(par.B, par.Z):
                keep.append(hit)
                continue
            if nhits >= max(par.b, par.z) and hit.Probab < par.p:
                keep.append(hit)
                continue
            if nhits >= max(par.b, par.z) and hit.Eval > par.E:
                keep.append(hit)
                continue
        if hit.matched_cols >= min_col_realign:
            keep.append(hit)
        nhits += 1
    hitlist.hits = keep


def premerge_hits(par: Parameters, q_re: HMM, qali, hitlist: HitList,
                  get_template, db, mats: SubstitutionMatrix,
                  ss: Optional[SecStrucMatrices],
                  previous_hits, premerged_hits,
                  min_col_realign: int = MINCOLS_REALIGN,
                  qali_allseqs=None):
    """HHblits::premerge (hhblits.cpp:1984-2066): MAC-realign the top
    ``par.premerge`` hits one at a time against the current query profile,
    merge each realigned hit into the query MSA, and rebuild the
    realign-stage query HMM with *prefilter* pseudocount parameters after
    every merge (hhblits.cpp:2038-2061).  The final ``perform_realign``
    then re-realigns every hit against this rebuilt q — which is why the
    reference's -atab scores and posteriors differ from a straight
    PrepareQueryHMM + realign pipeline.

    Mutates ``q_re`` (the realign query), ``qali`` and the hits in place;
    adds merged ``file__irep`` keys to ``premerged_hits``.
    """
    from ..core.profile import frequencies_and_transitions
    from .hhblits_merge import merge_hits_to_query

    Lmaxmem = int((par.maxmem - 0.5) * 1024 ** 3
                  / (2 * 8 + 8) / max(q_re.L, 1) / max(par.threads, 1))
    decoder = PosteriorDecoder(bool(par.loc), par.ssw_realign,
                               *((ss.S73, ss.S37, ss.S33) if ss
                                 else (None, None, None)))
    count = 0
    for hit in list(hitlist):
        if count >= par.premerge:
            break
        if hit.L > Lmaxmem or hit.light:
            continue
        if count >= max(par.B, par.Z):
            break
        if count >= max(par.b, par.z) and hit.Probab < par.p:
            break
        if count >= max(par.b, par.z) and hit.Eval > par.E:
            continue
        count += 1
        if hit.Eval > par.e:
            continue

        # single-hit realign against the current q
        # (PosteriorDecoderRunner::executeComputation with one hit)
        q_re.log2lin_transitions()
        prepare_query_transitions(q_re)
        t, fmt = get_template(hit.entry)
        t.log2lin_transitions()
        prepare_template_transitions(t)
        co = build_realign_cell_off(q_re, t, hit, par.min_overlap, [],
                                    par.exclstr, par.template_exclstr)
        decoder.realign(q_re, t, hit, co, par.shift, par.mact, par.corr)

        # merge the realigned hit into the query MSA (single-hit
        # mergeHitsToQuery, hhblits.cpp:2033) and mark it premerged
        single = HitList()
        single.extend([hit])
        merge_hits_to_query(par, qali, single, previous_hits, db, mats,
                            min_col_realign, premerged_hits,
                            qali_allseqs=qali_allseqs)
        premerged_hits.add(f"{hit.file}__{hit.irep}")

        # rebuild q from the merged MSA with prefilter pseudocounts
        # (hhblits.cpp:2038-2061)
        frequencies_and_transitions(qali, q_re, par.wg, par.mark, par.cons,
                                    par.showcons, mats.pb, mats.Sim)
        if par.notags:
            neutralize_tags(q_re, mats.pb)
        from ..cs.pseudocounts import get_context_engine
        ctx = get_context_engine(par)
        if ctx is not None:
            ctx.add_context_pseudocounts_prefilter(q_re)
        else:
            q_re.prepare_pseudocounts(mats.R)
            q_re.add_amino_acid_pseudocounts(
                par.pc_prefilter_nocontext_mode,
                par.pc_prefilter_nocontext_a,
                par.pc_prefilter_nocontext_b,
                par.pc_prefilter_nocontext_c)
        q_re.calculate_aa_background(mats.pb)
        q_re.add_transition_pseudocounts(par.gapd, par.gape, par.gapf,
                                         par.gapg, par.gaph, par.gapi,
                                         par.gapb)
        q_re.log2lin_transitions()


@gc_paused_fn
def run_hhalign(par: Parameters, query_text: str, template_texts:
                List[Tuple[str, str]], query_name: str = "query",
                device=None):
    """hhalign -i query -t templates (HHalign::run, hhalign.cpp:590-676).

    Returns (q, hitlist, qali) — like the reference, significant hits
    are merged into the query MSA (hhalign.cpp:658) and the profile is
    rebuilt from it, so -oa3m/-aa3m/-opsi/-ohhm reflect the merge.
    """
    dev = resolve_device(device)
    mats = get_substitution_matrix(par.matrix)
    ss = get_ss_matrices(par.ssa)
    q, qali, input_format = read_query_text(par, query_text, query_name,
                                            mats)
    prepare_query_hmm(par, q, mats, input_format)
    if par.notags:
        neutralize_tags(q, mats.pb)

    templates = []
    for name, text in template_texts:
        t, fmt = template_hmm_from_text(text, name, par, mats,
                                        use_global_weights=1)
        prepare_template_hmm(par, q, t, mats, fmt)
        templates.append((name, t))

    hits = viterbi_search(par, q, templates, ss_matrices=ss, device=dev)
    hitlist = HitList()
    hitlist.N_searched = len(templates)
    hitlist.extend(hits)
    hitlist.sort()
    hitlist.calculate_pvalues(q, par.loc, par.ssm, par.ssw)

    par.ssw = par.ssw_realign
    if par.realign:
        import copy

        def get_template(entry):
            # realign-stage templates rebuild with par.wg (the
            # posterior runner passes par.wg, not the Viterbi stage's
            # global weights — hhposteriordecoderrunner.cpp:92)
            for name, text in template_texts:
                if name == entry:
                    t, fmt = template_hmm_from_text(
                        text, name, par, mats,
                        use_global_weights=par.wg)
                    prepare_template_hmm(par, q, t, mats, fmt)
                    return t, fmt
            raise KeyError(entry)

        q_re = copy.deepcopy(q)
        perform_realign(par, q_re, hitlist, get_template, mats, ss,
                        min_col_realign=1, device=dev)

    # merge significant hits into the query MSA and rebuild the
    # profile (hhalign.cpp:658-668), so the -oa3m/-aa3m/-opsi/-ohhm
    # outputs carry the alignment like the reference
    if qali is not None and hitlist.hits:
        from ..core.profile import frequencies_and_transitions
        from .hhblits_merge import merge_hits_to_query

        class _FileDB:
            def __init__(self, texts):
                self._t = dict(texts)

            def get_template_a3m_text(self, name):
                return self._t[name]

        try:
            merge_hits_to_query(par, qali, hitlist, set(),
                                _FileDB(template_texts), mats,
                                min_col_realign=1)
            q_new = HMM()
            frequencies_and_transitions(qali, q_new, par.wg, par.mark,
                                        par.cons, par.showcons, mats.pb,
                                        mats.Sim)
            if par.notags:
                neutralize_tags(q_new, mats.pb)
            # keep the searched profile's identity on q for the hhr
            # writers: the reference's PrintHHR receives q_tmp, the
            # post-PrepareQueryHMM PRE-merge copy (hhalign.cpp:627
            # `*q_tmp = *q` before the search; hhblits.cpp:1818) — the
            # advisor's r2-low concern was checked against the
            # reference binary: hhr headers (No_of_seqs/Neff) match
            # this pre-merge choice byte-for-byte, and rebuilding q
            # from the merged MSA makes them DIVERGE.  The rebuilt
            # profile feeds -ohhm only (hhalign.cpp:661 rebuilds into
            # q after all hhr-relevant state is captured).
            q.merged_profile = q_new
        except KeyError:
            pass      # template text unavailable (e.g. hhm-only input)
    return q, hitlist, qali


@gc_paused_fn
@request("hhsearch")
def run_hhsearch(par: Parameters, query_text: str, db: HHDatabase,
                 query_name: str = "query", device=None):
    """hhsearch -i query -d db (single round, no prefilter) on
    ``device`` (default: the CUDA card), as one request
    (``hhsearch_query``)."""
    dev = resolve_device(device)
    mats = get_substitution_matrix(par.matrix)
    ss = get_ss_matrices(par.ssa)
    par.dbsize = db.size()
    with annotate("host_query_prep"):
        q, qali, input_format = read_query_text(par, query_text,
                                                query_name, mats)
        prepare_query_hmm(par, q, mats, input_format)
        if par.notags:
            neutralize_tags(q, mats.pb)

    entries = db.init_no_prefilter()
    templates = []
    with annotate("host_template_prep"):
        for name, seqlen in entries:
            t, fmt = db.get_template_hmm_search(name, par, mats, q,
                                                use_global_weights=1)
            templates.append((name, t))

    rpack = get_resident_pack(db, [n for n, _l in entries], par, mats, dev)
    with annotate("viterbi_search"):
        hits = viterbi_search(par, q, templates, ss_matrices=ss,
                              resident_pack=rpack, device=dev)
    hitlist = HitList()
    hitlist.N_searched = len(entries)
    hitlist.extend(hits)
    hitlist.sort()
    hitlist.calculate_pvalues(q, par.loc, par.ssm, par.ssw)
    # hhsearch never merges MSAs, so only display-rank light hits need
    # real paths (see promote_light_hits)
    with annotate("promote_light_hits"):
        promoted = promote_light_hits(par, q, hitlist, templates, ss,
                                      merge_window=False, device=dev)
    if promoted:
        hitlist.sort()
        hitlist.calculate_pvalues(q, par.loc, par.ssm, par.ssw)

    import copy

    q_re = copy.deepcopy(q)

    def get_template(entry):
        t, fmt = db.get_template_hmm_prepared(str(entry), par, mats,
                                              use_global_weights=par.wg)
        finish_template_hmm(par, q_re, t, mats)
        return t, fmt

    if par.premerge and db.a3m is not None:
        with annotate("host_premerge"):
            premerge_hits(par, q_re, qali, hitlist, get_template, db, mats,
                          ss, set(), set(), MINCOLS_REALIGN)
    if par.realign:
        with annotate("host_realign"):
            perform_realign(par, q_re, hitlist, get_template, mats, ss,
                            min_col_realign=MINCOLS_REALIGN, device=dev)
    # the reference's writers other than the hhr file (which uses the
    # round-start q_tmp) see the premerge-mutated q (hhblits.cpp:1838+)
    q.realign_q = q_re
    return q, hitlist


def neutralize_tags(q: HMM, pb: np.ndarray):
    """HMM::NeutralizeTags (hhhmm.cpp:2319-2354): neutralize His/myc/FLAG
    tag columns in the query profile (string positions, reference quirk)."""
    if q.nfirst < 0 or not q.seq:
        return
    qseq = q.seq[q.nfirst]
    L = q.L

    pos = qseq.find("HHHHH")
    if pos >= 0:
        i0 = pos + 1
        i = max(i0 - 8, 1)
        while i < i0 and i <= L + 1:
            q.p[i] = pb
            q.f[i] = pb
            i += 1
        pt = pos
        while pt < len(qseq) and qseq[pt] == "H":
            if i <= L + 1:
                q.p[i] = pb
                q.f[i] = pb
            i += 1
            pt += 1
        i1 = i
        while i < min(i1 + 8, L + 1):
            q.p[i] = pb
            q.f[i] = pb
            i += 1
    for tag, tlen in (("EQKLISEEDL", 10), ("DYKDDDDK", 8)):
        pos = qseq.find(tag)
        if pos >= 0:
            for i in range(pos + 1, min(pos + tlen, L + 1) + 1):
                q.p[i] = pb
                q.f[i] = pb
