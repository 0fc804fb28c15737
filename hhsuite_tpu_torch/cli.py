"""Console entry point of the port.

Usage:  python -m hhsuite_tpu_torch hhsearch -i q.a3m -d db [-o out.hhr]
        [-blasttab f] [-scores f] [-atab f] [options]
        python -m hhsuite_tpu_torch hhblits -i q.a3m -d db [-o out.hhr]
        [-blasttab f] [-oa3m f] [-n rounds] [options]
        python -m hhsuite_tpu_torch hhalign -i q.a3m -t t.a3m [-o out.hhr]
        [-oa3m f] [options]
        python -m hhsuite_tpu_torch hhblits_batch -i queries -d db -o out
        [-n rounds] [-hhsearch] [-cpu N] [-mesh N] [-queue dir | -shard k/N]
        [-rank R -size N -addr host:port] [-merge shard1,shard2,..]
        python -m hhsuite_tpu_torch hhblits_ca3m -i queries -d db -o out ...
        python -m hhsuite_tpu_torch hhpred -i q.fasta -o outbase -d db
        [-n rounds] [-mult N] [-horiz psipred.horiz] [-pdbdir dir]
        python -m hhsuite_tpu_torch <tool> [options]

Tools besides the searches: hhmake hhfilter hhconsensus cstranslate
reformat hhsuitedb addss mergeali hhmakemodel, the ffindex_* and a3m_*
database commands, the scripts (splitfasta check_a3m get_a3m_size
multithread create_profile_from_hhm create_profile_from_hmmer hh_reader)
and the PDB tools (cif2fasta pdbfilter pdb2fasta renumberpdb); run one
without arguments for its usage.  ``HHSUITE_TPU_TORCH_PROFILE=<dir>``
writes a ``torch.profiler`` trace of the whole command into <dir>.

``-mesh N`` shards each query's template batches over N cards (every
card by default when there is more than one; ``-nomesh`` turns it off);
``hhblits_batch`` searches every entry of an input ffindex
(``tools/batch.py``), ``hhblits_ca3m`` every entry of a compressed one.

Runs on the CUDA card unless ``HHSUITE_TPU_TORCH_DEVICE=cpu`` asks for
the CPU (plain PyTorch versions of every kernel).  Output-file wiring
mirrors the reference apps (src/hhblits_app.cpp:12-79, writers
src/hhblits.cpp:1816-1982).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from .args import activate_mesh, parse_args
from .constants import Parameters


def _read_infile(par) -> str:
    if par.infile in ("", "stdin"):
        return sys.stdin.read()
    with open(par.infile) as f:
        return f.read()


def _write(path: str, text: str, append: int = 0):
    if path == "stdout":
        sys.stdout.write(text)
    else:
        with open(path, "a" if append else "w") as f:
            f.write(text)


def _search_outputs(par, q, q_tmp, hitlist, qali, mats):
    """Write all requested output files (hhblits.cpp:1816-1982)."""
    from .apps import write_alignment_a3m, write_alignment_psi
    from .io.alignments import print_alignments
    from .io.hhm import write_hhm
    from .io.results import print_hit_list, print_m8, print_score_file

    argv = par.argv or []
    if par.outfile:
        out = print_hit_list(q_tmp or q, hitlist, par.maxdbstrlen, par.z,
                             par.Z, par.p, par.E, argv)
        out += print_alignments(q_tmp or q, hitlist, par, mats.S)
        _write(par.outfile, out)
    if par.m8file:
        _write(par.m8file, print_m8(q, hitlist, par.nseqdis, par.p, par.E))
    if par.pairwisealisfile:
        qp = getattr(q, "realign_q", q)
        _write(par.pairwisealisfile,
               print_alignments(qp, hitlist, par, mats.S,
                                outformat=par.outformat))
    if par.scorefile:
        _write(par.scorefile, print_score_file(q, hitlist))
    if par.alitabfile:
        from .io.results import write_alitab

        _write(par.alitabfile,
               write_alitab(q, hitlist, par.b, par.B, par.z, par.Z,
                            par.p, par.E))
    if par.matrices_output_file:
        from .io.results import print_matrices

        data = print_matrices(getattr(q, "realign_q", q), hitlist,
                              par.filter_matrices,
                              par.max_number_matrices, mats.S)
        if par.matrices_output_file == "stdout":
            sys.stdout.buffer.write(data)
        else:
            with open(par.matrices_output_file, "wb") as f:
                f.write(data)
    if par.alnfile and qali is not None:
        _write(par.alnfile, write_alignment_a3m(qali), par.append)
    if par.alisbasename:
        for rnd, ali in getattr(q, "alis", {}).items():
            _write(f"{par.alisbasename}_{rnd}.a3m",
                   write_alignment_a3m(ali), par.append)
    if par.psifile and qali is not None:
        _write(par.psifile, write_alignment_psi(qali), par.append)
    if par.hhmfile:
        # hhalign rebuilds the profile from the merged MSA before the
        # writers run (hhalign.cpp:661); the engine stores it on
        # q.merged_profile so the hhr keeps the searched profile's stats
        qh = getattr(q, "merged_profile", q)
        qh.add_amino_acid_pseudocounts(0, 0.0, 0.0, 1.0)
        qh.calculate_aa_background(mats.pb)
        _write(par.hhmfile,
               write_hhm(qh, mats.pb, par.max_seqid, par.coverage,
                         par.qid, par.Ndiff, par.qsc, argv), par.append)


def cmd_hhblits(argv: List[str]) -> int:
    from .matrices import get_substitution_matrix
    from .search.engine import open_databases
    from .search.hhblits import run_hhblits

    par = Parameters.hhblits_defaults()
    parse_args(argv, par)
    if not par.infile or not par.db_bases:
        print("hhblits -i <query a3m/hhm> -d <db basename> "
              "[-o out.hhr] [-blasttab f] [-oa3m f] [-n rounds] ...",
              file=sys.stderr)
        return 4
    activate_mesh(par)
    db = open_databases(par.db_bases)
    text = _read_infile(par)
    q, hitlist, qali = run_hhblits(par, text, db, par.infile)
    mats = get_substitution_matrix(par.matrix)
    if not par.outfile and not par.m8file and not par.scorefile:
        par.outfile = "stdout"
    _search_outputs(par, q, None, hitlist, qali, mats)
    return 0


def cmd_hhsearch(argv: List[str]) -> int:
    from .matrices import get_substitution_matrix
    from .search.engine import open_databases, run_hhsearch

    par = Parameters.hhsearch_defaults()
    parse_args(argv, par)
    if not par.infile or not par.db_bases:
        print("hhsearch -i <query> -d <db basename> [-o out.hhr] ...",
              file=sys.stderr)
        return 4
    activate_mesh(par)
    db = open_databases(par.db_bases)
    text = _read_infile(par)
    q, hitlist = run_hhsearch(par, text, db, par.infile)
    mats = get_substitution_matrix(par.matrix)
    if not par.outfile and not par.m8file and not par.scorefile:
        par.outfile = "stdout"
    _search_outputs(par, q, None, hitlist, None, mats)
    return 0


def cmd_hhalign(argv: List[str]) -> int:
    from .matrices import get_substitution_matrix
    from .search.engine import run_hhalign

    par = Parameters.hhalign_defaults()
    parse_args(argv, par)
    if not par.infile or not par.tfiles:
        print("hhalign -i <query> -t <template> [-o out.hhr] ...",
              file=sys.stderr)
        return 4
    text = _read_infile(par)
    templates = []
    for tf in par.tfiles:
        with open(tf) as f:
            templates.append((tf, f.read()))
    q, hitlist, qali = run_hhalign(par, text, templates, par.infile)
    mats = get_substitution_matrix(par.matrix)
    if not par.outfile and not par.m8file:
        par.outfile = "stdout"
    _search_outputs(par, q, None, hitlist, qali, mats)
    return 0


def cmd_hhblits_batch(argv: List[str]) -> int:
    """Many queries: every entry of an input ffindex (hhblits_omp,
    hhblits_mpi; tools/batch.py)."""
    from .tools.batch import main as batch_main

    return batch_main(argv)


def cmd_hhblits_ca3m(argv: List[str]) -> int:
    """The batch search over a compressed query database
    (src/hhblits_ca3m.cpp:120-240): each <in>_ca3m entry is expanded to
    a3m through <in>_{sequence,header} and searched like hhblits_omp."""
    from .tools.batch import main as batch_main

    return batch_main(list(argv) + ["-in_ca3m"])



def cmd_hhmake(argv: List[str]) -> int:
    from .apps import hhmake

    par = Parameters()
    par.nseqdis = 10
    par.gapb = 0.0
    par.nocontxt = True   # context data optional; see cs/ docs
    parse_args(argv, par)
    if not par.infile:
        print("hhmake -i <msa> [-o out.hhm]", file=sys.stderr)
        return 4
    if not par.outfile:
        base = par.infile.rsplit(".", 1)[0]
        par.outfile = base + ".hhm" if par.infile != "stdin" else "stdout"
    text = _read_infile(par)
    out = hhmake(text, par.infile, par, argv=["hhmake"] + list(argv))
    _write(par.outfile, out, par.append)
    return 0


def cmd_hhfilter(argv: List[str]) -> int:
    from .apps import hhfilter

    par = Parameters()
    par.nseqdis = par.maxseq - 1
    par.Ndiff = 0
    parse_args(argv, par)
    if not par.infile or not par.outfile:
        print("hhfilter -i <in.a3m> -o <out.a3m> [-id N] [-diff N] ...",
              file=sys.stderr)
        return 4
    text = _read_infile(par)
    _write(par.outfile, hhfilter(text, par.infile, par), par.append)
    return 0


def cmd_hhconsensus(argv: List[str]) -> int:
    from .apps import hhconsensus

    par = Parameters()
    par.nseqdis = par.maxseq - 1
    par.showcons = 0
    par.cons = 1
    par.Ndiff = 0
    par.max_seqid = 100
    par.coverage = 0
    par.pc_hhm_nocontext_a = 0.0
    par.gapb = 0.0
    par.nocontxt = True
    parse_args(argv, par)
    if not par.infile:
        print("hhconsensus -i <in.a3m> [-s out.seq] [-oa3m out.a3m]",
              file=sys.stderr)
        return 4
    text = _read_infile(par)
    cons_fa, a3m = hhconsensus(text, par.infile, par)
    if par.outfile:
        _write(par.outfile, cons_fa, 1)
    if par.alnfile:
        _write(par.alnfile, a3m, par.append)
    return 0



def _cstranslate_chunk(items, alphabet, modelfile, pc_admix, pc_ali,
                       weight_as):
    """Worker for the cstranslate process pool: builds the context
    library + pseudocount engine once, translates its chunk."""
    from .cs.context_lib import (ContextLibrary, cstranslate_a3m,
                                  default_pc_engine)

    if alphabet and alphabet != "internal":
        with open(alphabet) as f:
            lib = ContextLibrary.from_text(f.read())
    else:
        lib = ContextLibrary.default_cs219()
    pc_engine = None
    if modelfile:
        pc_engine = default_pc_engine(
            None if modelfile == "internal" else modelfile)
    return [(name, cstranslate_a3m(text, lib, w_center=weight_as,
                                   pc_engine=pc_engine,
                                   pc_admix=pc_admix, pc_ali=pc_ali))
            for name, text in items]


def cmd_cstranslate(argv: List[str]) -> int:
    """cstranslate -i <in> -o <out> [-f] [-I a3m|ca3m] [-x admix] [-c ali]
    [-A alphabet.lib] [-D context.lib|.crf] [-w weight].

    Parity: CSTranslateApp (src/cs/cstranslate_app.h:365-390 ParseOptions;
    defaults Init():58-73: pc_admix=0.90, pc_ali=12.0, weight_as=1000,
    modelfile=alphabetfile="internal").  ``-b`` is accepted and ignored —
    the reference's getopt_pp parser has no 'b' option either, so
    ``data/test.sh:30-33``'s ``-b`` is a no-op there too.
    """
    from .cs.context_lib import (ContextLibrary, cstranslate_a3m,
                                  default_pc_engine)
    from .io.ffindex import FFindexDatabase, FFindexWriter

    infile = outfile = None
    ffmode = False
    alphabet = None
    modelfile = "internal"
    informat = "auto"
    pc_admix, pc_ali = 0.90, 12.0
    weight_as = 1000.0
    threads = 0
    outformat = "seq"              # -O seq|prf (cstranslate_app.h:61)
    match_assign = None            # -M: None = by-query, else gap rule
    appendfile = None              # -a: append instead of/next to -o
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-i", "--infile"):
            i += 1
            infile = argv[i]
        elif a in ("-o", "--outfile"):
            i += 1
            outfile = argv[i]
        elif a in ("-A", "--alphabet"):
            i += 1
            alphabet = argv[i]
        elif a in ("-D", "--context-data"):
            i += 1
            modelfile = argv[i]
        elif a in ("-x", "--pc-admix"):
            i += 1
            pc_admix = float(argv[i])
        elif a in ("-c", "--pc-ali"):
            i += 1
            pc_ali = float(argv[i])
        elif a in ("-w", "--weight"):
            i += 1
            weight_as = float(argv[i])
        elif a in ("-I", "--informat"):
            i += 1
            informat = argv[i]
        elif a in ("-f", "--ffindex"):
            ffmode = True
        elif a in ("-cpu", "--threads"):
            i += 1
            threads = int(argv[i])
        elif a in ("-O", "--outformat"):
            i += 1
            outformat = argv[i]
        elif a in ("-M", "--match-assign"):
            i += 1
            match_assign = float(argv[i])
            if match_assign < 0:       # kAssignMatchColsByQuery
                match_assign = None
        elif a in ("-a", "--appendfile"):
            i += 1
            appendfile = argv[i]
        elif a in ("-v", "--verbose"):
            i += 1
        i += 1
    if not infile or not (outfile or appendfile) \
            or (ffmode and not outfile):
        print("cstranslate -i <in> [-o <out>] [-a <append>] [-f]",
              file=sys.stderr)
        return 4
    if alphabet and alphabet != "internal":
        with open(alphabet) as f:
            lib = ContextLibrary.from_text(f.read())
    else:
        lib = ContextLibrary.default_cs219()
    pc_engine = None
    if modelfile:
        pc_engine = default_pc_engine(
            None if modelfile == "internal" else modelfile)

    fmt = informat
    if fmt == "auto":
        ext = infile.rsplit(".", 1)[-1] if "." in infile else ""
        fmt = ext if ext in ("fas", "fasta", "seq", "prf") else "a3m"

    def translate(text: str) -> bytes:
        if outformat == "prf":
            from .cs.context_lib import write_state_profile

            _seq, post = cstranslate_a3m(
                text, lib, w_center=weight_as, pc_engine=pc_engine,
                pc_admix=pc_admix, pc_ali=pc_ali,
                match_assign=match_assign, return_profile=True,
                informat=fmt)
            # GetBasename + substr(0, len-1): the reference chops the
            # last basename character (cstranslate_app.h:601-602 quirk)
            name = os.path.basename(infile).rsplit(".", 1)[0][:-1]
            # raw single-byte alphabet chars like the reference's fputc
            return write_state_profile(post, name).encode("latin-1")
        return cstranslate_a3m(text, lib, w_center=weight_as,
                               pc_engine=pc_engine, pc_admix=pc_admix,
                               pc_ali=pc_ali, match_assign=match_assign,
                               informat=fmt)

    if ffmode:
        if informat == "ca3m":
            # ca3m triplet input (cstranslate_app.h:214-241): -i is the
            # base path; entries are decompressed before translation
            from .io.ca3m import extract_a3m

            src = FFindexDatabase(infile + "_ca3m.ffdata",
                                  infile + "_ca3m.ffindex")
            seq_db = FFindexDatabase(infile + "_sequence.ffdata",
                                     infile + "_sequence.ffindex")
            hdr_db = FFindexDatabase(infile + "_header.ffdata",
                                     infile + "_header.ffindex")
            items = [(name, extract_a3m(data, seq_db, hdr_db))
                     for name, data in src.items()]
        else:
            src = FFindexDatabase(infile + ".ffdata", infile + ".ffindex")
            items = [(name, data.decode()) for name, data in src.items()]
        # parallel fan-out over entries (the cstranslate_mpi role,
        # src/cs/cstranslate_mpi_app.h: MPQ-dealt entry ranges); one
        # engine per worker process, input order preserved
        nproc = threads or min(os.cpu_count() or 1, 8)
        if nproc > 1 and len(items) > 3:
            from concurrent.futures import ProcessPoolExecutor
            from functools import partial

            chunks = [items[k:: nproc] for k in range(nproc)]
            work = partial(_cstranslate_chunk, alphabet=alphabet,
                           modelfile=modelfile, pc_admix=pc_admix,
                           pc_ali=pc_ali, weight_as=weight_as)
            # spawn: a fork of a process whose torch thread pools (or
            # CUDA context) have started is not safe
            import multiprocessing

            with ProcessPoolExecutor(
                    max_workers=nproc,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                parts = list(ex.map(work, chunks))
            # reassemble by POSITION (chunk k item m = original index
            # k + m*nproc): a name-keyed merge would collapse duplicate
            # entry names to one worker's payload, unlike the serial
            # path which translates each entry independently
            results: List = [None] * len(items)
            for k, part in enumerate(parts):
                for m, (_name, payload) in enumerate(part):
                    pos = k + m * nproc
                    results[pos] = (items[pos][0], payload)
        else:
            results = [(name, translate(text)) for name, text in items]
        with FFindexWriter(outfile + ".ffdata",
                           outfile + ".ffindex") as w:
            for name, payload in results:
                w.add(name, payload)
    else:
        with open(infile) as f:
            seq = translate(f.read())
        if outfile:
            with open(outfile, "wb") as f:
                f.write(seq)
        if appendfile:        # -a: append (WriteStateSequence append=true)
            with open(appendfile, "ab") as f:
                f.write(seq)
    return 0


def cmd_ffindex_build(argv: List[str]) -> int:
    from .io.ffindex import FFindexWriter

    rest = [a for a in argv if a != "-s"]   # the index is always sorted
    if len(rest) < 3:
        print("ffindex_build [-s] <data> <index> <files...>",
              file=sys.stderr)
        return 4
    data, index = rest[0], rest[1]
    with FFindexWriter(data, index) as w:
        for path in rest[2:]:
            with open(path, "rb") as f:
                w.add(os.path.basename(path), f.read())
    return 0


def cmd_ffindex_get(argv: List[str]) -> int:
    from .io.ffindex import FFindexDatabase

    if len(argv) < 3:
        print("ffindex_get <data> <index> <names...>", file=sys.stderr)
        return 4
    db = FFindexDatabase(argv[0], argv[1])
    for name in argv[2:]:
        sys.stdout.write(db.read_text(name))
    return 0


def _getopt(argv: List[str], optmap: dict) -> dict:
    """Tiny getopt-style parser: optmap maps '-x' -> key (value opts)."""
    out = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in optmap:
            i += 1
            out[optmap[a]] = argv[i]
        i += 1
    return out


def cmd_a3m_database_reduce(argv: List[str]) -> int:
    """a3m ffindex -> ca3m ffindex (src/a3m_database_reduce.cpp)."""
    from .io.ca3m import compress_a3m
    from .io.ffindex import FFindexDatabase, FFindexWriter

    o = _getopt(argv, {"-i": "i", "-o": "o", "-d": "d"})
    if not all(k in o for k in "iod"):
        print("a3m_database_reduce -i <a3m db> -o <ca3m db> "
              "-d <sequence db>", file=sys.stderr)
        return 4
    a3m = FFindexDatabase(o["i"] + ".ffdata", o["i"] + ".ffindex")
    seq = FFindexDatabase(o["d"] + ".ffdata", o["d"] + ".ffindex")
    with FFindexWriter(o["o"] + ".ffdata", o["o"] + ".ffindex") as w:
        for name, data in a3m.items():
            body = compress_a3m(data.decode("utf-8", "replace"), seq)
            if body is None:
                print(f"WARNING: could not compress {name}",
                      file=sys.stderr)
                continue
            w.add(name, body)
    return 0


def cmd_a3m_database_extract(argv: List[str]) -> int:
    """ca3m ffindex -> a3m ffindex (src/a3m_database_extract.cpp)."""
    from .io.ca3m import extract_a3m
    from .io.ffindex import FFindexDatabase, FFindexWriter

    o = _getopt(argv, {"-i": "i", "-o": "o", "-d": "d", "-q": "q"})
    if not all(k in o for k in "iodq"):
        print("a3m_database_extract -i <ca3m db> -o <a3m db> "
              "-d <sequence db> -q <header db>", file=sys.stderr)
        return 4
    ca3m = FFindexDatabase(o["i"] + ".ffdata", o["i"] + ".ffindex")
    seq = FFindexDatabase(o["d"] + ".ffdata", o["d"] + ".ffindex")
    hdr = FFindexDatabase(o["q"] + ".ffdata", o["q"] + ".ffindex")
    with FFindexWriter(o["o"] + ".ffdata", o["o"] + ".ffindex") as w:
        for name, data in ca3m.items():
            w.add(name, extract_a3m(data, seq, hdr).encode())
    return 0


def cmd_a3m_database_filter(argv: List[str]) -> int:
    """Copy entries whose name appears in the filter list
    (src/a3m_database_filter.cpp)."""
    from .io.ffindex import FFindexDatabase, FFindexWriter

    o = _getopt(argv, {"-i": "i", "-o": "o", "-s": "s"})
    if not all(k in o for k in "ios"):
        print("a3m_database_filter -i <db> -o <db> -s <name list file>",
              file=sys.stderr)
        return 4
    with open(o["s"]) as f:
        allowed = set(f.read().split())
    src = FFindexDatabase(o["i"] + ".ffdata", o["i"] + ".ffindex")
    with FFindexWriter(o["o"] + ".ffdata", o["o"] + ".ffindex") as w:
        for name, data in src.items():
            if name in allowed:
                w.add(name, data)
    return 0


def cmd_a3m_reduce(argv: List[str]) -> int:
    """Single a3m file -> ca3m (src/a3m_reduce.cpp)."""
    from .io.ca3m import compress_a3m
    from .io.ffindex import FFindexDatabase

    o = _getopt(argv, {"-i": "i", "-o": "o", "-d": "d"})
    if "d" not in o:
        print("a3m_reduce [-i in.a3m] [-o out.ca3m] -d <sequence db>",
              file=sys.stderr)
        return 4
    text = (sys.stdin.read() if o.get("i") in (None, "stdin")
            else open(o["i"]).read())
    seq = FFindexDatabase(o["d"] + ".ffdata", o["d"] + ".ffindex")
    body = compress_a3m(text, seq)
    if body is None:
        print("ERROR: could not compress a3m", file=sys.stderr)
        return 1
    if o.get("o") in (None, "stdout"):
        sys.stdout.buffer.write(body)
    else:
        with open(o["o"], "wb") as f:
            f.write(body)
    return 0


def cmd_a3m_extract(argv: List[str]) -> int:
    """Single ca3m file -> a3m (src/a3m_extract.cpp)."""
    from .io.ca3m import extract_a3m
    from .io.ffindex import FFindexDatabase

    o = _getopt(argv, {"-i": "i", "-o": "o", "-d": "d", "-q": "q"})
    if "d" not in o or "q" not in o:
        print("a3m_extract [-i in.ca3m] [-o out.a3m] -d <sequence db> "
              "-q <header db>", file=sys.stderr)
        return 4
    data = (sys.stdin.buffer.read() if o.get("i") in (None, "stdin")
            else open(o["i"], "rb").read())
    seq = FFindexDatabase(o["d"] + ".ffdata", o["d"] + ".ffindex")
    hdr = FFindexDatabase(o["q"] + ".ffdata", o["q"] + ".ffindex")
    out = extract_a3m(data, seq, hdr)
    _write(o.get("o") or "stdout", out)
    return 0


def cmd_hhsuitedb(argv: List[str]) -> int:
    from .tools.hhsuitedb import main as hhsuitedb_main

    return hhsuitedb_main(argv)


def cmd_ffindex_apply(argv: List[str]) -> int:
    """Run a command over every entry (lib/ffindex/src/
    ffindex_apply_mpi.c serial mode): entry data on stdin, stdout
    captured into the output database.  With ``-queue <shared dir>``,
    any number of cooperating processes (across hosts on a shared
    filesystem) split the entries via the atomic claim queue and one
    of them writes the merged output — byte-identical to a serial run
    (the reference's MPI lane, ffindex_apply_mpi.c:552)."""
    import subprocess

    from .io.ffindex import FFindexDatabase, FFindexWriter

    out_data = out_index = queue_dir = None
    rest = list(argv)
    if "-d" in rest:
        k = rest.index("-d")
        out_data = rest[k + 1]
        del rest[k: k + 2]
    if "-i" in rest:
        k = rest.index("-i")
        out_index = rest[k + 1]
        del rest[k: k + 2]
    if "-queue" in rest:
        k = rest.index("-queue")
        queue_dir = rest[k + 1]
        del rest[k: k + 2]
    if "--" in rest:
        k = rest.index("--")
        files, prog = rest[:k], rest[k + 1:]
    else:
        files, prog = rest[:2], rest[2:]
    if len(files) < 2 or not prog or (queue_dir and not (
            out_data and out_index)):
        print("ffindex_apply <data> <index> [-d out.ffdata -i "
              "out.ffindex] [-queue <shared dir>] -- program [args]",
              file=sys.stderr)
        return 4
    db = FFindexDatabase(files[0], files[1])
    if queue_dir:
        from .tools.batch import queue_fanout

        names = [e.name for e in db.entries]

        def compute(name):
            res = subprocess.run(prog, input=db.read_bytes(name),
                                 capture_output=True)
            return {"out": res.stdout}

        def merge(pdir):
            with FFindexWriter(out_data, out_index) as w:
                for name in names:
                    p = os.path.join(pdir,
                                     name.replace("/", "_") + ".out")
                    with open(p, "rb") as f:
                        w.add(name, f.read())

        queue_fanout(queue_dir, names, compute, merge)
        return 0
    writer = (FFindexWriter(out_data, out_index)
              if out_data and out_index else None)
    for name, payload in db.items():
        res = subprocess.run(prog, input=payload,
                             capture_output=True)
        if writer is not None:
            writer.add(name, res.stdout)
        else:
            sys.stdout.buffer.write(res.stdout)
    if writer is not None:
        writer.close()
    return 0


def cmd_ffindex_modify(argv: List[str]) -> int:
    """ffindex_modify -u -f <names file> <index>: unlink entries from
    an index (lib/ffindex/src/ffindex_modify.c); -s sorts."""
    names_file = None
    sort = False
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-f":
            i += 1
            names_file = argv[i]
        elif a == "-u":
            pass
        elif a == "-s":
            sort = True
        else:
            rest.append(a)
        i += 1
    if not rest:
        print("ffindex_modify [-s] [-u -f namesfile] <index>",
              file=sys.stderr)
        return 4
    index_path = rest[0]
    remove = set()
    if names_file:
        with open(names_file) as f:
            remove = set(f.read().split())
    lines = []
    with open(index_path) as f:
        for line in f:
            if line.strip() and line.split("\t")[0] not in remove:
                lines.append(line)
    if sort:
        lines.sort(key=lambda l: l.split("\t")[0])
    with open(index_path, "w") as f:
        f.writelines(lines)
    return 0


def cmd_ffindex_order(argv: List[str]) -> int:
    """ffindex_order <orderfile> <data> <index> <outdata> <outindex>:
    rewrite a database in the given entry order."""
    from .io.ffindex import FFindexDatabase, FFindexWriter

    if len(argv) < 5:
        print("ffindex_order <orderfile> <data> <index> <outdata> "
              "<outindex>", file=sys.stderr)
        return 4
    with open(argv[0]) as f:
        order = f.read().split()
    db = FFindexDatabase(argv[1], argv[2])
    with FFindexWriter(argv[3], argv[4]) as w:
        for name in order:
            if name in db:
                w.add(name, db.read_bytes(name))
    return 0


def cmd_ffindex_unpack(argv: List[str]) -> int:
    """ffindex_unpack <data> <index> <outdir>: write each entry to a
    file."""
    from .io.ffindex import FFindexDatabase

    if len(argv) < 3:
        print("ffindex_unpack <data> <index> <outdir>", file=sys.stderr)
        return 4
    db = FFindexDatabase(argv[0], argv[1])
    os.makedirs(argv[2], exist_ok=True)
    for name, payload in db.items():
        with open(os.path.join(argv[2], name), "wb") as f:
            f.write(payload)
    return 0


def cmd_reformat(argv: List[str]) -> int:
    from .tools.reformat import main as reformat_main

    return reformat_main(argv)


def cmd_ffindex_from_fasta(argv: List[str]) -> int:
    """FASTA -> ffindex of full records (lib/ffindex/src/
    ffindex_from_fasta.c); -n names entries 1..N instead of by first
    header word."""
    from .io.ffindex import FFindexWriter

    numeric = "-n" in argv
    rest = [a for a in argv if a not in ("-s", "-n")]
    if len(rest) < 3:
        print("ffindex_from_fasta [-s] [-n] <data> <index> <fasta>",
              file=sys.stderr)
        return 4
    data_path, index_path, fasta_path = rest[:3]
    with open(fasta_path) as f:
        text = f.read()
    records = []
    cur = None
    for line in text.splitlines(keepends=True):
        if line.startswith(">"):
            if cur is not None:
                records.append(cur)
            cur = line
        elif cur is not None:
            cur += line
    if cur is not None:
        records.append(cur)
    with FFindexWriter(data_path, index_path) as w:
        for k, rec in enumerate(records):
            if numeric:
                name = str(k + 1)
            else:
                name = rec[1:].split()[0] if rec[1:].split() else str(k + 1)
            w.add(name, rec.encode())
    return 0


def cmd_ffindex_reduce(argv: List[str]) -> int:
    """Pipe every entry of a database to a program's stdin
    (lib/ffindex/src/ffindex_reduce.c); unlike ffindex_apply the
    program's stdout is NOT captured into a new database."""
    import subprocess

    from .io.ffindex import FFindexDatabase

    if len(argv) < 3:
        print("ffindex_reduce <data> <index> <program> [args]",
              file=sys.stderr)
        return 4
    db = FFindexDatabase(argv[0], argv[1])
    prog = argv[2:]
    for _name, payload in db.items():
        subprocess.run(prog, input=payload)
    return 0


def cmd_ffindex_from_fasta_with_split(argv: List[str]) -> int:
    """FASTA -> separate header + sequence databases
    (lib/ffindex/src/ffindex_from_fasta_with_split.c).  Headers keep
    their '>' and lose the newline; sequences are concatenated without
    newlines.  Entry names are the first header word, shortened to the
    second '|'-field when present (get_short_id); -s sorts the indices.
    Refuses to overwrite existing outputs like the reference."""
    from .io.ffindex import FFindexWriter

    sort = "-s" in argv
    rest = [a for a in argv if not a.startswith("-")]
    if len(rest) < 5:
        print("ffindex_from_fasta_with_split [-s] <hdr.ffdata> "
              "<hdr.ffindex> <seq.ffdata> <seq.ffindex> <fasta>",
              file=sys.stderr)
        return 4
    hdr_d, hdr_i, seq_d, seq_i, fasta = rest[:5]
    for pth in (hdr_d, hdr_i, seq_d, seq_i):
        if os.path.exists(pth):
            print(f"{pth}: File exists", file=sys.stderr)
            return 1
    with open(fasta) as f:
        text = f.read()
    entries = []
    seq_id = 0
    for block in text.split("\n>"):
        block = block.lstrip(">").strip("\n")
        if not block.strip():
            continue
        seq_id += 1
        lines = block.split("\n")
        header = ">" + lines[0]
        seq = "".join(l.strip() for l in lines[1:])
        name = lines[0].split()[0] if lines[0].split() else str(seq_id)
        if "|" in name:
            parts = name.split("|")
            if len(parts) >= 2 and parts[1]:
                name = parts[1]
            else:
                print(f"Warning: short id could not be extracted from "
                      f"'{name}'!", file=sys.stderr)
        entries.append((name, header, seq))
    if sort:
        entries.sort(key=lambda e: e[0])
    with FFindexWriter(hdr_d, hdr_i) as wh, \
            FFindexWriter(seq_d, seq_i) as ws:
        for name, header, seq in entries:
            wh.add(name, header.encode())
            ws.add(name, seq.encode())
    return 0


# the script and tool commands (tools/*.py), each its module's entry


def cmd_splitfasta(argv: List[str]) -> int:
    from .tools.scripts import splitfasta

    return splitfasta(argv)


def cmd_check_a3m(argv: List[str]) -> int:
    from .tools.scripts import check_a3m

    return check_a3m(argv)


def cmd_get_a3m_size(argv: List[str]) -> int:
    from .tools.scripts import get_a3m_size

    return get_a3m_size(argv)


def cmd_multithread(argv: List[str]) -> int:
    from .tools.scripts import multithread

    return multithread(argv)


def cmd_create_profile_from_hhm(argv: List[str]) -> int:
    from .tools.scripts import create_profile_from_hhm

    return create_profile_from_hhm(argv)


def cmd_create_profile_from_hmmer(argv: List[str]) -> int:
    from .tools.scripts import create_profile_from_hmmer

    return create_profile_from_hmmer(argv)


def cmd_hh_reader(argv: List[str]) -> int:
    from .tools.scripts import hh_reader

    return hh_reader(argv)


def cmd_cif2fasta(argv: List[str]) -> int:
    from .tools.pdbtools import cif2fasta

    return cif2fasta(argv)


def cmd_pdbfilter(argv: List[str]) -> int:
    from .tools.pdbtools import pdbfilter

    return pdbfilter(argv)


def cmd_pdb2fasta(argv: List[str]) -> int:
    from .tools.pdbtools import pdb2fasta

    return pdb2fasta(argv)


def cmd_renumberpdb(argv: List[str]) -> int:
    from .tools.pdbtools import renumberpdb

    return renumberpdb(argv)


def cmd_mergeali(argv: List[str]) -> int:
    from .tools.mergeali import mergeali

    return mergeali(argv)


def cmd_addss(argv: List[str]) -> int:
    from .tools.addss import addss

    return addss(argv)


def cmd_hhpred(argv: List[str]) -> int:
    """hhblits -> addss -> hhsearch -> template selection -> PIR
    (tools/hhpred.py); its search stages run on the card unless the
    device variable asks for the CPU."""
    from .tools.hhpred import hhpred

    return hhpred(argv)


def cmd_hhmakemodel(argv: List[str]) -> int:
    from .tools.hhmakemodel import main as hhmakemodel_main

    return hhmakemodel_main(argv)


COMMANDS = {
    "hhblits": cmd_hhblits,
    "hhsearch": cmd_hhsearch,
    "hhalign": cmd_hhalign,
    "hhmake": cmd_hhmake,
    "hhfilter": cmd_hhfilter,
    "hhconsensus": cmd_hhconsensus,
    "cstranslate": cmd_cstranslate,
    "ffindex_build": cmd_ffindex_build,
    "ffindex_get": cmd_ffindex_get,
    "ffindex_from_fasta": cmd_ffindex_from_fasta,
    "a3m_database_reduce": cmd_a3m_database_reduce,
    "a3m_database_extract": cmd_a3m_database_extract,
    "a3m_database_filter": cmd_a3m_database_filter,
    "a3m_reduce": cmd_a3m_reduce,
    "a3m_extract": cmd_a3m_extract,
    "hhsuitedb": cmd_hhsuitedb,
    "ffindex_reduce": cmd_ffindex_reduce,
    "ffindex_from_fasta_with_split": cmd_ffindex_from_fasta_with_split,
    "hhblits_ca3m": cmd_hhblits_ca3m,
    "splitfasta": cmd_splitfasta,
    "check_a3m": cmd_check_a3m,
    "get_a3m_size": cmd_get_a3m_size,
    "multithread": cmd_multithread,
    "create_profile_from_hhm": cmd_create_profile_from_hhm,
    "create_profile_from_hmmer": cmd_create_profile_from_hmmer,
    "hh_reader": cmd_hh_reader,
    "cif2fasta": cmd_cif2fasta,
    "pdbfilter": cmd_pdbfilter,
    "pdb2fasta": cmd_pdb2fasta,
    "renumberpdb": cmd_renumberpdb,
    "mergeali": cmd_mergeali,
    "addss": cmd_addss,
    "hhpred": cmd_hhpred,
    "hhblits_batch": cmd_hhblits_batch,
    "reformat": cmd_reformat,
    "ffindex_apply": cmd_ffindex_apply,
    "ffindex_modify": cmd_ffindex_modify,
    "ffindex_order": cmd_ffindex_order,
    "ffindex_unpack": cmd_ffindex_unpack,
    "hhmakemodel": cmd_hhmakemodel,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m hhsuite_tpu_torch <tool> [options]\n"
              "tools: " + " ".join(sorted(COMMANDS)), file=sys.stderr)
        return 2
    from .profiling import trace_if_enabled

    with trace_if_enabled():
        return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
