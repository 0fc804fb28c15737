"""Command-line argument parsing compatible with the reference tools.

Mirrors the hand-rolled ProcessArguments parsers (src/hhblits.cpp:414-820
and friends): single-dash long flags, value-taking options, and the same
defaults adjustments.
"""

from __future__ import annotations

import sys
from typing import List

from .constants import Parameters


def _f(v):
    return float(v)


def _i(v):
    return int(v)


# flag -> (Parameters attribute, converter); flags without value map to
# (attr, None) and set the given constant
_VALUE_FLAGS = {
    "-i": ("infile", str),
    "-o": ("outfile", str),
    "-oa3m": ("alnfile", str),
    "-ohhm": ("hhmfile", str),
    "-opsi": ("psifile", str),
    "-blasttab": ("m8file", str),
    "-scores": ("scorefile", str),
    "-atab": ("alitabfile", str),
    "-omat": ("matrices_output_file", str),
    "-oalis": ("alisbasename", str),
    "-n": ("num_rounds", _i),
    "-v": ("v", _i),
    "-p": ("p", _f),
    "-P": ("p", _f),
    "-E": ("E", _f),
    "-e": ("e", _f),
    "-b": ("b", _i),
    "-B": ("B", _i),
    "-z": ("z", _i),
    "-Z": ("Z", _i),
    "-seq": ("nseqdis", _i),
    "-aliw": ("aliwidth", _i),
    "-id": ("max_seqid", _i),
    "-qid": ("qid", _i),
    "-qsc": ("qsc", _f),
    "-cov": ("coverage", _i),
    "-diff": ("Ndiff", _i),
    "-neff": ("Neff", _f),
    "-Neff": ("Neff", _f),
    "-M": ("M", None),            # special: 'a2m'|'a3m'|'first'|<int>
    "-Mgaps": ("Mgaps", _i),
    "-shift": ("shift", _f),
    "-corr": ("corr", _f),
    "-ssm": ("ssm", _i),
    "-ssw": ("ssw", _f),
    "-mact": ("mact", _f),
    "-cpu": ("threads", _i),
    "-maxres": ("maxres", _i),
    "-maxseq": ("maxseq", _i),
    "-maxmem": ("maxmem", _f),
    "-maxfilt": ("maxnumdb", _i),
    "-realign_max": ("realign_max", _i),
    "-alt": ("altali", _i),
    "-smin": ("smin", _f),
    "-gapb": ("gapb", _f),
    "-gapd": ("gapd", _f),
    "-gape": ("gape", _f),
    "-gapf": ("gapf", _f),
    "-gapg": ("gapg", _f),
    "-gaph": ("gaph", _f),
    "-gapi": ("gapi", _f),
    "-pc_hhm_contxt_mode": ("pc_hhm_context_mode", _i),
    "-pc_hhm_contxt_a": ("pc_hhm_context_a", _f),
    "-pc_hhm_contxt_b": ("pc_hhm_context_b", _f),
    "-pc_hhm_contxt_c": ("pc_hhm_context_c", _f),
    "-pc_hhm_contxt_neff": ("pc_hhm_context_target_neff", _f),
    "-pc_prefilter_contxt_mode": ("pc_prefilter_context_mode", _i),
    "-pc_prefilter_contxt_a": ("pc_prefilter_context_a", _f),
    "-pc_prefilter_contxt_b": ("pc_prefilter_context_b", _f),
    "-pc_prefilter_contxt_c": ("pc_prefilter_context_c", _f),
    "-pc_prefilter_contxt_neff": ("pc_prefilter_context_target_neff", _f),
    "-pc_hhm_nocontxt_mode": ("pc_hhm_nocontext_mode", _i),
    "-pc_hhm_nocontxt_a": ("pc_hhm_nocontext_a", _f),
    "-pc_hhm_nocontxt_b": ("pc_hhm_nocontext_b", _f),
    "-pc_hhm_nocontxt_c": ("pc_hhm_nocontext_c", _f),
    "-pre_evalue_thresh": ("prefilter_evalue_thresh", _f),
    "-min_prefilter_hits": ("min_prefilter_hits", _i),
    "-neffmax": ("neffmax", _f),
    "-contxt": ("clusterfile", str),
    "-cslib": ("cs_library", str),
    "-name": ("name_override", str),
    "-excl": ("exclstr", str),
    "-dbstrlen": ("maxdbstrlen", int),
    "-template_excl": ("template_exclstr", str),
    "-premerge": ("premerge", _i),
    "-mark": ("mark_flag", None),
    # E-value calibration (hhblits.cpp:704-711)
    "-alphaa": ("alphaa", _f),
    "-alphab": ("alphab", _f),
    "-alphac": ("alphac", _f),
    # prefilter tuning (hhblits.cpp:719-730)
    "-prepre_smax_thresh": ("preprefilter_smax_thresh", _i),
    "-pre_bitfactor": ("prefilter_bit_factor", _i),
    "-pre_gap_open": ("prefilter_gap_open", _i),
    "-pre_gap_extend": ("prefilter_gap_extend", _i),
    "-pre_score_offset": ("prefilter_score_offset", _i),
    # end-gap penalties (hhblits.cpp:699-702)
    "-egq": ("egq", _f),
    "-egt": ("egt", _f),
    "-ssa": ("ssa", _f),
    "-sc": ("columnscore", _i),
    "-mapt": ("mact", _f),
    "-ovlp": ("min_overlap", _i),
    "-csb": ("csb", _f),
    "-csw": ("csw", _f),
    "-context_data": ("clusterfile", str),      # alias (hhblits.cpp:442)
    "-cs_lib": ("cs_library", str),             # alias (hhblits.cpp:449)
    "-pc_prefilter_nocontxt_mode": ("pc_prefilter_nocontext_mode", _i),
    "-pc_prefilter_nocontxt_a": ("pc_prefilter_nocontext_a", _f),
    "-pc_prefilter_nocontxt_b": ("pc_prefilter_nocontext_b", _f),
    "-pc_prefilter_nocontxt_c": ("pc_prefilter_nocontext_c", _f),
}

_BOOL_FLAGS = {
    "-nocontxt": ("nocontxt", True),
    "-filter_matrices": ("filter_matrices", True),
    "-loc": ("loc", 1),
    "-local": ("loc", 1),
    "-wg": ("wg", 1),
    "-hide_cons": ("showcons", 0),
    "-hide_pred": ("showpred", 0),
    "-hide_dssp": ("showdssp", 0),
    "-show_ssconf": ("showconf", 1),
    "-all": ("allseqs", True),
    "-nodiff": ("allseqs", True),
    "-norealign": ("realign", 0),
    "-realign": ("realign", 1),
    "-notags": ("notags", 1),
    "-tags": ("notags", 0),
    "-mark": ("mark", 1),
    "-add_cons": ("cons", 1),
    "-noaddfilter": ("already_seen_filter", False),
    "-nopre": ("prefilter", False),
    "-pre": ("prefilter", True),
    "-allseqs": ("allseqs", True),
    "-realign_old_hits": ("realign_old_hits", True),
    "-append": ("append", 1),
}


def parse_args(argv: List[str], par: Parameters) -> Parameters:
    """Fill ``par`` from an hh-suite style argv (excluding program name)."""
    par.argv = list(argv)
    tfiles = []
    db_bases = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-d":
            i += 1
            db_bases.append(argv[i])
        elif a == "-t":
            i += 1
            tfiles.append(argv[i])
        elif a in ("-Ofas", "-Oa2m", "-Oa3m"):
            par.outformat = {"-Ofas": 1, "-Oa2m": 2, "-Oa3m": 3}[a]
            i += 1
            par.pairwisealisfile = argv[i]
        elif a == "-M":
            i += 1
            v = argv[i]
            if v in ("a2m", "a3m"):
                par.M = 1
            elif v == "first":
                par.M = 3
            else:
                par.M = 2
                par.Mgaps = int(v)
        elif a in ("-glob", "-global"):
            # -glob resets a still-default mact to 0 (hhblits.cpp:712-717)
            par.loc = 0
            if 0.35 < par.mact < 0.3502:
                par.mact = 0.0
        elif a == "-noprefilt":
            # disables both the prefilter and the already-seen filter
            # (hhblits.cpp:712-714)
            par.prefilter = False
            par.already_seen_filter = False
        elif a == "-scwin":
            # local aa background column score (hhblits.cpp:767-770)
            i += 1
            par.columnscore = 5
            par.half_window_size_local_aa_bg_freqs = max(1, int(argv[i]))
        elif a == "-interim_filter":
            # NONE|FULL (hhblits.cpp:796-812)
            i += 1
            v = argv[i] if i < len(argv) else ""
            if v == "NONE":
                par.interim_filter = 0
            elif v == "FULL":
                par.interim_filter = 1
            else:
                print("ERROR: no state out of NONE|FULL following "
                      "-interim_filter", file=sys.stderr)
                raise SystemExit(4)
        elif a == "-aa3m":
            # append query alignment in a3m format (hhalign.cpp:331-339)
            i += 1
            par.alnfile = argv[i]
            par.append = 1
        elif a == "-apsi":
            # append query alignment in PSI-BLAST format (hhalign.cpp:341)
            i += 1
            par.psifile = argv[i]
            par.append = 1
        elif a == "-index":
            # parsed like the reference (hhalign.cpp:363-371), which
            # stores but never consumes it in v3
            i += 1
            par.indexfile = argv[i]
        elif a == "-Gonnet":
            par.matrix = 0
        elif a.startswith("-BLOSUM") or a.startswith("-Blosum"):
            # matrix selectors (hhblits.cpp:569-584)
            if a[7:] in ("30", "40", "50", "62", "65", "80"):
                par.matrix = int(a[7:])
            else:
                print(f"WARNING: ignoring unknown option {a}",
                      file=sys.stderr)
        elif a in _BOOL_FLAGS:
            attr, val = _BOOL_FLAGS[a]
            setattr(par, attr, val)
        elif a in _VALUE_FLAGS:
            attr, conv = _VALUE_FLAGS[a]
            i += 1
            if conv is not None:
                setattr(par, attr, conv(argv[i]))
            else:
                setattr(par, attr, argv[i])
        elif a == "-h" or a == "--help":
            setattr(par, "show_help", True)
        else:
            print(f"WARNING: ignoring unknown option {a}",
                  file=sys.stderr)
            # skip a following value if it doesn't look like a flag
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
        i += 1
    par.tfiles = tfiles
    par.db_bases = db_bases
    # option compatibility fixups (hhsearch.cpp:36-53 etc.)
    if par.b > par.B:
        par.B = par.b
    if par.z > par.Z:
        par.Z = par.z
    if par.maxmem < 1.0:
        par.maxmem = 1.0
    if par.mact >= 1.0:
        par.mact = 0.999
    elif par.mact < 0:
        par.mact = 0.0
    if par.altali < 1:
        par.altali = 1
    from . import log as hhlog
    hhlog.set_level(par.v)
    return par
