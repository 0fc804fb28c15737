"""mergeali: merge the MSAs of seed sequences through a master alignment
(equivalent of scripts/mergeali.pl).

The master file is a FASTA alignment of seed sequences.  For every seed,
its own MSA <name>.a3m is located in the search directories, the seed's
residues are aligned to the master copy (identity NW via
tools/align_util, like Align.pm in the reference), and each member
sequence is re-gapped into the master's column space: master match
columns become upper-case/'-' states, slave residues that fall between
mapped columns become lower-case inserts.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

from .align_util import align_identity


def _read_fasta(path: str) -> List[Tuple[str, str]]:
    recs = []
    name = None
    buf: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    recs.append((name, "".join(buf)))
                name = line[1:]
                buf = []
            elif not line.startswith("#"):
                buf.append(line.strip())
    if name is not None:
        recs.append((name, "".join(buf)))
    return recs


def _slave_layout(seq: str):
    """First a3m sequence -> per-residue (n -> (is_match, j)) and the
    total number of match states."""
    loc = []
    j = 0
    for c in seq:
        if c in ".":
            continue
        if c.isupper() or c == "-":
            j += 1
            if c != "-":
                loc.append((True, j))
        elif c.islower():
            loc.append((False, j))
    return loc, j


def _slave_rows(seqs: List[str], nmatch: int):
    """Each a3m sequence -> (match_chars[1..n], inserts_after[j])."""
    rows = []
    for s in seqs:
        match = ["-"] * (nmatch + 1)
        ins: Dict[int, str] = {}
        j = 0
        for c in s:
            if c == ".":
                continue
            if c.isupper() or c == "-":
                j += 1
                match[j] = c
            elif c.islower():
                ins[j] = ins.get(j, "") + c
        rows.append((match, ins))
    return rows


def mergeali(argv: List[str]) -> int:
    infile = outfile = None
    indirs = ["."]
    mark = False
    first_only = False
    diff = None
    aliname = None
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            infile = argv[i]
        elif a == "-o":
            i += 1
            outfile = argv[i]
        elif a == "-d":
            dirs = []
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                dirs.append(argv[i])
            indirs = dirs or indirs
        elif a == "-mark":
            mark = True
        elif a == "-first":
            first_only = True
        elif a == "-all":
            first_only = False
        elif a == "-diff":
            i += 1
            diff = int(argv[i])
        elif a == "-name":
            i += 1
            aliname = argv[i]
        elif a in ("-full", "-v"):
            pass
        else:
            rest.append(a)
        i += 1
    if infile is None and rest:
        infile = rest.pop(0)
    if outfile is None and rest:
        outfile = rest.pop(0)
    if not infile or not outfile:
        print("mergeali <master.fas> <out.a3m> [-d dirs..] [-all|-first]"
              " [-diff N] [-name x] [-mark]", file=sys.stderr)
        return 4

    seeds = _read_fasta(infile)
    if not seeds:
        print(f"ERROR: no sequences in {infile}", file=sys.stderr)
        return 1
    ncol = max(len(s) for _n, s in seeds)
    seeds = [(n, s.ljust(ncol, "-")) for n, s in seeds]

    # match columns of the master (mergeali.pl -all / -first)
    if first_only:
        match_cols = [c for c in range(ncol)
                      if seeds[0][1][c] not in "-."]
    else:
        match_cols = [c for c in range(ncol)
                      if any(s[c] not in "-." for _n, s in seeds)]

    out_records: List[Tuple[str, str]] = []
    nseq = 0
    for name, master_row in seeds:
        word = name.split()[0] if name.split() else ""
        alifile = None
        for d in indirs:
            cand = os.path.join(d, word + ".a3m")
            if os.path.exists(cand):
                alifile = cand
                break
        if alifile is None:
            print(f"Warning: could not find {word}.a3m in "
                  f"{' '.join(indirs)}", file=sys.stderr)
            continue
        slave = _read_fasta(alifile)
        if diff:
            from ..core.alignment import Alignment
            from ..matrices import get_substitution_matrix

            text = "".join(f">{n}\n{s}\n" for n, s in slave)
            ali = Alignment.from_a3m_text(text, infile=alifile)
            ali.compress(M=1)
            mats = get_substitution_matrix("blosum62")
            ali.N_filtered = ali.filter(100, mats.S, 0, 0, -20.0, diff)
            keep_names = {ali.names[k] for k in range(ali.N_in)
                          if ali.keep[k]}
            slave = [(n, s) for n, s in slave
                     if (n.split()[0] if n.split() else n) in
                     {kn.split()[0] if kn.split() else kn
                      for kn in keep_names}] or slave

        seed_master_res = [c for c in master_row if c not in "-."]
        loc, nmatch = _slave_layout(slave[0][1])
        slave_res = "".join(
            slave[0][1][k] for k in range(len(slave[0][1]))
            if slave[0][1][k] not in "-.").upper()
        _sc, mpos, spos = align_identity(
            "".join(seed_master_res).upper(), slave_res)
        res2slave = dict(zip(mpos, spos))   # 1-based residue indices

        # master column -> slave match state (when the seed residue
        # lands on a match state in its own MSA)
        col2j: Dict[int, int] = {}
        n_res = 0
        for c in range(ncol):
            if master_row[c] in "-.":
                continue
            n_res += 1
            sidx = res2slave.get(n_res)
            if sidx is None or sidx > len(loc):
                continue
            is_match, j = loc[sidx - 1]
            if is_match:
                col2j[c] = j

        rows = _slave_rows([s for _n, s in slave], nmatch)
        mapped_js = sorted(col2j.values())
        for (sname, _s), (mrow, ins) in zip(slave, rows):
            parts: List[str] = []
            prev_j = None
            for c in match_cols:
                j = col2j.get(c)
                if j is None:
                    parts.append("-")
                    continue
                # unmapped slave match states between prev_j and j
                if prev_j is not None and j > prev_j + 1:
                    for jj in range(prev_j + 1, j):
                        if jj not in mapped_js and mrow[jj] != "-":
                            parts.append(mrow[jj].lower())
                        if jj in ins:
                            parts.append(ins[jj])
                parts.append(mrow[j])
                if j in ins:
                    parts.append(ins[j])
                prev_j = j
            body = "".join(parts)
            out_name = ("@" + sname) if (mark and sname == name) else sname
            out_records.append((out_name, body))
            nseq += 1

    with open(outfile, "w") as out:
        if aliname:
            out.write(f"#{aliname}\n")
        for n, s in out_records:
            out.write(f">{n}\n{s}\n")
    print(f"Merged {nseq} sequences into {outfile}", file=sys.stderr)
    return 0
