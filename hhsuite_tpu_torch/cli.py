"""Console entry point of the port.

Usage:  python -m hhsuite_tpu_torch hhsearch -i q.a3m -d db [-o out.hhr]
        [-blasttab f] [-scores f] [-atab f] [options]
        python -m hhsuite_tpu_torch hhblits -i q.a3m -d db [-o out.hhr]
        [-blasttab f] [-oa3m f] [-n rounds] [options]
        python -m hhsuite_tpu_torch hhalign -i q.a3m -t t.a3m [-o out.hhr]
        [-oa3m f] [options]

Runs on the CUDA card unless ``HHSUITE_TPU_TORCH_DEVICE=cpu`` asks for
the CPU (plain PyTorch versions of every kernel).  Output-file wiring
mirrors the reference apps (src/hhblits_app.cpp:12-79, writers
src/hhblits.cpp:1816-1982).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .args import parse_args
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


COMMANDS = {
    "hhalign": cmd_hhalign,
    "hhblits": cmd_hhblits,
    "hhsearch": cmd_hhsearch,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m hhsuite_tpu_torch <tool> [options]\n"
              "tools: " + " ".join(sorted(COMMANDS)), file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
