"""reformat: MSA format conversion (scripts/reformat.pl equivalent).

Supported formats (the ones the hh-suite pipelines actually use,
scripts/reformat.pl:1-120): fas (aligned FASTA), a2m, a3m, sto
(Stockholm), psi (PSI-BLAST), clu (Clustal).  Conversion goes through a
common aligned-FASTA intermediate; a3m insert columns are expanded
against the match-column structure exactly like reformat.pl's
a3m->fas path (dots padded so all rows align).

Options mirrored from reformat.pl (scripts/reformat.pl:60-85):
-M first|<int> (match-state assignment), -r (remove insert states),
-r <int> (remove insert columns with more than X% gaps), -g ''|'-'
(gap representation; '' = unaligned), -uc/-lc, -num ('1:name' prefixes),
-noss (drop ss_* rows), -sa (keep sa_* rows, removed by default),
-d <len> (truncate name lines), -l <width>; output format ufas
(unaligned FASTA, implies -g '').
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional, Tuple

FORMATS = ("fas", "a2m", "a3m", "sto", "psi", "clu", "ufas")


def _parse_fasta_like(text: str) -> List[Tuple[str, str]]:
    pairs: List[Tuple[str, str]] = []
    name = None
    seq: List[str] = []
    for line in text.splitlines():
        if line.startswith(">"):
            if name is not None:
                pairs.append((name, "".join(seq)))
            name = line[1:].strip()
            seq = []
        elif line.startswith("#") and name is None:
            continue
        elif name is not None:
            seq.append(line.strip())
    if name is not None:
        pairs.append((name, "".join(seq)))
    return pairs


def _parse_sto(text: str) -> List[Tuple[str, str]]:
    seqs: dict = {}
    order: List[str] = []
    for line in text.splitlines():
        if not line.strip() or line.startswith(("# STOCKHOLM", "//")):
            continue
        if line.startswith("#=GC "):
            parts = line.split()
            name = "ss_cons" if parts[1] == "SS_cons" else None
            if name is None:
                continue
            key = "#" + parts[1]
            if key not in seqs:
                order.append(key)
                seqs[key] = []
            seqs[key].append(parts[2])
            continue
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            continue
        name, chunk = parts
        if name not in seqs:
            order.append(name)
            seqs[name] = []
        seqs[name].append(chunk)
    return [(n.lstrip("#"), "".join(seqs[n]).replace(".", "-"))
            for n in order if not n.startswith("#")]


def _parse_psi(text: str) -> List[Tuple[str, str]]:
    seqs: dict = {}
    order: List[str] = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) != 2:
            continue
        name, chunk = parts
        if name not in seqs:
            order.append(name)
            seqs[name] = []
        seqs[name].append(chunk)
    return [(n, "".join(seqs[n])) for n in order]


def _parse_clu(text: str) -> List[Tuple[str, str]]:
    seqs: dict = {}
    order: List[str] = []
    for line in text.splitlines():
        if (not line.strip() or line.startswith(("CLUSTAL", "MUSCLE"))
                or set(line.strip()) <= set(".:* ")):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        name, chunk = parts[0], parts[1]
        if name not in seqs:
            order.append(name)
            seqs[name] = []
        seqs[name].append(chunk)
    return [(n, "".join(seqs[n])) for n in order]


def _a3m_to_aligned(pairs: List[Tuple[str, str]]
                    ) -> List[Tuple[str, str]]:
    """Expand a3m insert (lowercase) columns so all rows align
    (reformat.pl a3m branch: insert positions become '.' in other
    rows)."""
    # number of inserts after each match column, per sequence
    max_ins: dict = {}
    parsed = []
    for name, seq in pairs:
        cols: List[Tuple[int, str]] = []   # (match_col_index, insert_str)
        m = 0
        ins = ""
        for c in seq:
            if c.islower():
                ins += c
            else:
                cols.append((m, ins))
                ins = ""
                m += 1
        parsed.append((name, seq, m))
        tail = ins
        pos = 0
        ins = ""
        m = 0
        for c in seq:
            if c.islower():
                ins += c
            else:
                max_ins[m] = max(max_ins.get(m, 0), len(ins))
                ins = ""
                m += 1
        max_ins[m] = max(max_ins.get(m, 0), len(ins))
    out = []
    for name, seq, nm in parsed:
        chunks = []
        ins = ""
        m = 0
        for c in seq:
            if c.islower():
                ins += c
            else:
                chunks.append(ins + "." * (max_ins.get(m, 0) - len(ins)))
                chunks.append(c)
                ins = ""
                m += 1
        chunks.append(ins + "." * (max_ins.get(m, 0) - len(ins)))
        out.append((name, "".join(chunks)))
    return out


def read_msa(text: str, informat: str) -> List[Tuple[str, str]]:
    if informat == "sto":
        return _parse_sto(text)
    if informat == "psi":
        return _parse_psi(text)
    if informat == "clu":
        return _parse_clu(text)
    pairs = _parse_fasta_like(text)
    if informat == "a3m":
        return _a3m_to_aligned(pairs)
    return pairs


def _assign_match_states(pairs, M) -> List[bool]:
    L = len(pairs[0][1])
    if M == "first":
        ref = pairs[0][1]
        return [c not in "-." for c in ref]
    try:
        thresh = int(M)
    except (TypeError, ValueError):
        # a2m/a3m: uppercase/'-' are match columns
        cols = []
        for k in range(L):
            c = next((p[1][k] for p in pairs if p[1][k] not in "."),
                     ".")
            cols.append(not (c.islower() or c == "."))
        return cols
    n = len(pairs)
    out = []
    for k in range(L):
        gaps = sum(1 for _nm, s in pairs if s[k] in "-.")
        out.append(100.0 * gaps / n < thresh)
    return out


def write_msa(pairs: List[Tuple[str, str]], outformat: str,
              M=None, remove_inserts: bool = False,
              remove_gapped: int = 0,
              case: Optional[str] = None, number: bool = False,
              width: int = 100, noss: bool = False,
              keep_sa: bool = False, gap: Optional[str] = None,
              desclen: int = 0, lname: int = 0,
              update: bool = False) -> str:
    if noss:
        pairs = [(n, s) for (n, s) in pairs
                 if not re.match(r"(ss_|aa_)", n)]
    if not keep_sa:
        # solvent accessibility rows are removed by default
        # (reformat.pl:99 $nosa=1; -sa keeps them)
        pairs = [(n, s) for (n, s) in pairs if not n.startswith("sa_")]
    if remove_inserts and pairs:
        # -r: drop insert (non-match) columns AFTER -M processing
        # (reformat.pl:72-73,131-132)
        match = _assign_match_states(pairs, M)
        pairs = [(n, "".join(c for c, m in zip(s, match) if m))
                 for n, s in pairs]
    elif remove_gapped and pairs:
        # -r <int>: drop insert columns with more than X% gaps
        match = _assign_match_states(pairs, M)
        nrow = len(pairs)
        L = len(pairs[0][1])
        keep = []
        for k in range(L):
            if match[k]:
                keep.append(True)
                continue
            gaps = sum(1 for _n, s in pairs if s[k] in "-.")
            keep.append(100.0 * gaps / nrow <= remove_gapped)
        pairs = [(n, "".join(c for c, m in zip(s, keep) if m))
                 for n, s in pairs]
    if number:
        # '1:name' prefixes (reformat.pl:65 -num)
        pairs = [(f"{i + 1}:{n}", s)
                 for i, (n, s) in enumerate(pairs)]
    if desclen:
        pairs = [(n[:desclen], s) for n, s in pairs]
    if outformat == "ufas":
        gap = ""            # reformat.pl:205
        outformat = "fas"
    if gap == "":
        pairs = [(n, s.replace("-", "").replace(".", ""))
                 for n, s in pairs]
    elif gap == "-":
        pairs = [(n, s.replace(".", "-")) for n, s in pairs]
    if case == "uc":
        pairs = [(n, s.upper()) for n, s in pairs]
    elif case == "lc":
        pairs = [(n, s.lower()) for n, s in pairs]

    if outformat in ("a2m", "a3m") and pairs:
        # no -M given: first-sequence residues define match columns
        # (reformat.pl:535)
        match = _assign_match_states(pairs, M or "first")
        conv = []
        for n, s in pairs:
            chars = []
            for c, is_m in zip(s, match):
                if is_m:
                    chars.append("-" if c in "-." else c.upper())
                else:
                    chars.append("." if c in "-." else c.lower())
            seq = "".join(chars)
            if outformat == "a3m":
                seq = seq.replace(".", "")
            conv.append((n, seq))
        pairs = conv

    if outformat in ("fas", "a2m", "a3m"):
        out = []
        for n, s in pairs:
            if outformat == "fas":
                s = s.replace(".", "-")
            out.append(">" + n)
            if outformat == "a3m":
                out.append(s)
            else:
                for k in range(0, len(s), width):
                    out.append(s[k: k + width])
        return "\n".join(out) + "\n"
    lname = lname or None
    if outformat == "sto":
        out = ["# STOCKHOLM 1.0", ""]
        if lname:
            # reformat.pl:747-771: fixed "%-N.Ns %s" name column
            for n, s in pairs:
                nm = n.split()[0]
                out.append(f"{nm[:lname]:<{lname}} "
                           + s.replace(".", "-").upper())
        else:
            w = max((len(n.split()[0]) for n, _s in pairs),
                    default=0) + 2
            for n, s in pairs:
                out.append(f"{n.split()[0]:<{w}}"
                           + s.replace(".", "-").upper())
        out.append("//")
        return "\n".join(out) + "\n"
    if outformat == "psi":
        out = []
        if lname:
            for n, s in pairs:
                nm = n.split()[0]
                out.append(f"{nm[:lname]:<{lname}} "
                           + s.replace(".", "-").upper())
        else:
            w = max((len(n.split()[0]) for n, _s in pairs),
                    default=0) + 2
            for n, s in pairs:
                out.append(f"{n.split()[0]:<{w}}"
                           + s.replace(".", "-").upper())
        return "\n".join(out) + "\n"
    if outformat == "clu":
        out = ["CLUSTAL W multiple sequence alignment", ""]
        nw = lname or 18
        names = [n.split()[0][:nw] for n, _s in pairs]
        seqs = [s.replace(".", "-").upper() for _n, s in pairs]
        L = max((len(s) for s in seqs), default=0)
        pad = (lname + 2) if lname else 20
        for start in range(0, L, 60):
            for nm, s in zip(names, seqs):
                out.append(f"{nm:<{pad}}{s[start: start + 60]}")
            out.append("")
        return "\n".join(out) + "\n"
    raise ValueError(f"unknown output format {outformat}")


def reformat(text: str, informat: str, outformat: str, **kw) -> str:
    pairs = read_msa(text, informat)
    if not pairs:
        raise ValueError("no sequences found")
    return write_msa(pairs, outformat, **kw)


def _sniff(path: str) -> Optional[str]:
    ext = path.rsplit(".", 1)[-1].lower()
    aliases = {"fasta": "fas", "fa": "fas", "afa": "fas",
               "aln": "clu", "stk": "sto", "stockholm": "sto"}
    f = aliases.get(ext, ext)
    return f if f in FORMATS else None


def _rebuild_opt_args(opts) -> List[str]:
    """Re-serialize parsed options for batch-mode recursion."""
    out: List[str] = []
    if opts["M"] is not None:
        out += ["-M", str(opts["M"])]
    if opts["remove_inserts"]:
        out.append("-r")
    if opts["remove_gapped"]:
        out += ["-r", str(opts["remove_gapped"])]
    if opts["gap"] is not None:
        out += ["-g", opts["gap"]]
    if opts["case"]:
        out.append("-" + opts["case"])
    if opts["number"]:
        out.append("-num")
    if opts["noss"]:
        out.append("-noss")
    if opts["keep_sa"]:
        out.append("-sa")
    if opts["desclen"]:
        out += ["-d", str(opts["desclen"])]
    if opts["width"] != 100:
        out += ["-l", str(opts["width"])]
    if opts.get("lname"):
        out += ["-lname", str(opts["lname"])]
    if opts.get("update"):
        out.append("-u")
    return out


def main(argv: List[str]) -> int:
    opts = {"M": None, "remove_inserts": False, "remove_gapped": 0,
            "case": None, "number": False, "width": 100, "noss": False,
            "keep_sa": False, "gap": None, "desclen": 0, "lname": 0,
            "update": False}
    pos: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-M":
            i += 1
            opts["M"] = argv[i]
        elif a == "-r":
            # -r [int]: bare -r removes inserts; -r X removes insert
            # columns with more than X% gaps (reformat.pl:131-132)
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 1
                opts["remove_gapped"] = int(argv[i])
            else:
                opts["remove_inserts"] = True
        elif a == "-g":
            i += 1
            opts["gap"] = argv[i]
        elif a == "-uc":
            opts["case"] = "uc"
        elif a == "-lc":
            opts["case"] = "lc"
        elif a == "-num":
            opts["number"] = True
        elif a == "-noss":
            opts["noss"] = True
        elif a == "-sa":
            opts["keep_sa"] = True
        elif a == "-d":
            i += 1
            opts["desclen"] = int(argv[i])
        elif a == "-lname":
            # fixed name-column width for clustal/stockholm/psi output
            # (reformat.pl:113,141,747-790)
            i += 1
            opts["lname"] = int(argv[i])
        elif a == "-u":
            # update mode: skip files whose outfile already exists
            # (reformat.pl:111,139,218)
            opts["update"] = True
        elif a == "-v":
            i += 1
        elif a == "-i":
            i += 1
            pos.append(argv[i])
        elif a == "-o":
            i += 1
            pos.append(argv[i])
        elif not a.startswith("-"):
            pos.append(a)
        elif a == "-l":
            i += 1
            opts["width"] = int(argv[i])
        i += 1
    if len(pos) == 4:
        informat, outformat, infile, outfile = pos
    elif len(pos) == 2:
        infile, outfile = pos
        # batch mode (reformat.pl:175-199): a glob pattern as infile
        # plus an extension as outfile converts every matching file
        if ("*" in infile or "?" in infile) and "/" not in outfile \
                and not outfile.startswith("stdout"):
            import glob as _glob
            import os as _os

            ext = outfile.lstrip(".")
            outformat = _sniff(ext) or ext
            rc = 0
            for f in sorted(_glob.glob(infile)):
                of = _os.path.splitext(f)[0] + "." + ext
                rc |= main(argv=[a for a in []] + [
                    _sniff(f) or "fas", outformat, f, of]
                    + _rebuild_opt_args(opts))
            return rc
        informat = _sniff(infile)
        outformat = _sniff(outfile)
    else:
        print("reformat [informat outformat] infile outfile "
              "[-M first|int] [-r] [-uc|-lc] [-num] [-noss] [-l width]",
              file=sys.stderr)
        return 4
    if informat not in FORMATS or outformat not in FORMATS:
        print(f"unrecognized format (supported: {' '.join(FORMATS)})",
              file=sys.stderr)
        return 4
    if opts.get("update") and outfile not in ("stdout",) \
            and os.path.exists(outfile):
        return 0      # -u: keep the existing output (reformat.pl:218)
    text = (sys.stdin.read() if infile == "stdin"
            else open(infile).read())
    out = reformat(text, informat, outformat, **opts)
    if outfile == "stdout":
        sys.stdout.write(out)
    else:
        with open(outfile, "w") as f:
            f.write(out)
    return 0
