"""Utility scripts from the reference scripts/ directory.

One function per tool, each a from-scratch equivalent of the cited Perl
or Python script:

- splitfasta        (scripts/splitfasta.pl)
- check_a3m         (scripts/check_a3m.py)
- get_a3m_size      (scripts/get_a3m_size.py)
- multithread       (scripts/multithread.pl)
- create_profile_from_hhm    (scripts/create_profile_from_hhm.pl)
- create_profile_from_hmmer  (scripts/create_profile_from_hmmer.pl)
- hh_reader         (scripts/hh_reader.py main())
"""

from __future__ import annotations

import math
import os
import re
import sys
from typing import List

# HHM column order (hhdecl.h s2a) -> cs/prf alphabet ARNDCQEGHILKMFPSTWYV
HHMAA2CSAA = (0, 4, 3, 6, 13, 7, 8, 9, 11, 10, 12, 2, 14, 5, 1, 15, 16,
              19, 17, 18)
PRF_AMINOACIDS = "ARNDCQEGHILKMFPSTWYV"


def splitfasta(argv: List[str]) -> int:
    """Split a multi-FASTA file into single-sequence files in the
    current directory, named by the first header word
    (scripts/splitfasta.pl); -fam groups SCOP-style names by family
    directory, -ext sets the extension (default 'seq')."""
    ext = "seq"
    fam = False
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-fam":
            fam = True
        elif a == "-name":
            fam = False
        elif a == "-ext":
            i += 1
            ext = argv[i]
        else:
            rest.append(a)
        i += 1
    if not rest:
        print("splitfasta <infile.fas> [-fam|-name] [-ext <ext>]",
              file=sys.stderr)
        return 4
    n = 0
    out = None
    numfams: dict = {}
    with open(rest[0]) as f:
        for line in f:
            if line.startswith(">"):
                if out is not None:
                    out.close()
                word = line[1:].split()[0] if line[1:].split() else f"seq{n}"
                name = re.sub(r"[^A-Za-z0-9._-]", "_", word)
                if fam:
                    # SCOP id like d1abc.1 a.1.2.3 -> family subdir
                    m = re.match(r"\S+\s+(\S+)", line[1:])
                    famid = m.group(1) if m else "unknown"
                    os.makedirs(famid, exist_ok=True)
                    numfams[famid] = numfams.get(famid, 0) + 1
                    name = os.path.join(famid, name)
                out = open(f"{name}.{ext}", "w")
                out.write(line)
                n += 1
            elif out is not None:
                out.write(line)
    if out is not None:
        out.close()
    print(f"Created {n} sequence files", file=sys.stderr)
    return 0


def check_a3m(argv: List[str]) -> int:
    """Validate an a3m file (scripts/check_a3m.py)."""
    from .a3m_container import A3MContainer, A3MFormatError

    if not argv:
        print("check_a3m <file.a3m|stdin>", file=sys.stderr)
        return 4
    fh = sys.stdin if argv[0].lower() == "stdin" else open(argv[0])
    try:
        c = A3MContainer()
        c.read_a3m(fh)
    except A3MFormatError as e:
        sys.stderr.write(str(e))
        return 1
    finally:
        if fh is not sys.stdin:
            fh.close()
    return 0


def get_a3m_size(argv: List[str]) -> int:
    """Print the number of sequences in an a3m
    (scripts/get_a3m_size.py)."""
    from .a3m_container import A3MContainer, A3MFormatError

    if not argv:
        print("get_a3m_size <file.a3m|stdin>", file=sys.stderr)
        return 4
    fh = sys.stdin if argv[0].lower() == "stdin" else open(argv[0])
    try:
        c = A3MContainer()
        c.read_a3m(fh)
        print(c.number_sequences)
    except A3MFormatError as e:
        sys.stderr.write(str(e))
        return 1
    finally:
        if fh is not sys.stdin:
            fh.close()
    return 0


def multithread(argv: List[str]) -> int:
    """Run a command over many files with N parallel workers
    (scripts/multithread.pl): '$file' in the command is replaced by
    each globbed file name."""
    import glob as _glob
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    cpu = 1
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "-cpu":
            i += 1
            cpu = int(argv[i])
        elif argv[i] == "-v":
            i += 1
        else:
            rest.append(argv[i])
        i += 1
    if len(rest) < 2:
        print("multithread '<fileglob>' '<command with $file>' "
              "[-cpu <int>]", file=sys.stderr)
        return 4
    files = sorted(_glob.glob(rest[0]))
    cmd_tpl = rest[1]

    def run(path):
        cmd = cmd_tpl.replace("$file", path)
        return subprocess.call(cmd, shell=True)

    with ThreadPoolExecutor(max_workers=max(cpu, 1)) as ex:
        rcs = list(ex.map(run, files))
    return 0 if all(rc == 0 for rc in rcs) else 1


def _parse_io_opts(argv: List[str]):
    infile = outfile = None
    factor = 1.0
    i = 0
    while i < len(argv):
        if argv[i] == "-i":
            i += 1
            infile = argv[i]
        elif argv[i] == "-o":
            i += 1
            outfile = argv[i]
        elif argv[i] == "-factor":
            i += 1
            factor = float(argv[i])
        elif argv[i] == "-v":
            i += 1
        i += 1
    if infile and not outfile:
        outfile = re.sub(r"\.\w+$", "", infile) + ".prf"
    return infile, outfile, factor


def _write_prf(outfile: str, name: str, length: int, counts, neffs):
    with open(outfile, "w") as out:
        out.write("CountProfile\n")
        out.write(f"NAME\t{name}\n")
        out.write(f"LENG\t{length}\n")
        out.write("ALPH\t20\n")
        out.write("COUNTS\t" + "\t".join(PRF_AMINOACIDS) + "\tNEFF\n")
        for i in range(length):
            row = [str(i + 1)]
            for a in range(20):
                v = counts[i][a]
                row.append("*" if v == "*" else str(int(v)))
            row.append(str(int(neffs[i])))
            out.write("\t".join(row) + "\n")
        out.write("//\n")


def create_profile_from_hhm(argv: List[str]) -> int:
    """HHM -> cs CountProfile .prf (scripts/create_profile_from_hhm.pl):
    the 20 HMMSCALE scores per column are re-ordered into the
    ARNDCQEGHILKMFPSTWYV alphabet, zeros are bumped to 1, and the
    column Neff (in units of 0.001) is carried over."""
    infile, outfile, _ = _parse_io_opts(argv)
    if not infile:
        print("create_profile_from_hhm -i <infile.hhm> [-o <out.prf>]",
              file=sys.stderr)
        return 4
    name = ""
    length = 0
    counts: List[list] = []
    neffs: List[int] = []
    with open(infile) as f:
        for line in f:
            m = re.match(r"NAME\s+(\S+)", line)
            if m:
                name = m.group(1)
            m = re.match(r"LENG\s+(\d+)", line)
            if m:
                length = int(m.group(1))
            if line.startswith("HMM"):
                break
        it = iter(f)
        for line in it:
            if line.startswith("//"):
                break
            if re.match(r"^\S \d+ ", line):
                toks = line.split()
                row = [0] * 20
                for a in range(20):
                    v = toks[2 + a]
                    if v == "*":
                        row[HHMAA2CSAA[a]] = "*"
                    else:
                        row[HHMAA2CSAA[a]] = int(v) or 1
                counts.append(row)
                trans = next(it).split()
                neffs.append(int(trans[7]))
    _write_prf(outfile, name, length, counts, neffs)
    return 0


def create_profile_from_hmmer(argv: List[str]) -> int:
    """HMMER2/HMMER3 -> cs CountProfile .prf
    (scripts/create_profile_from_hmmer.pl): per column the query
    residue gets count 1 and the HMMER match-emission distribution is
    mixed in with -factor, then the row is normalized (the reference
    prints the normalized fractions with %i, which this reproduces)."""
    infile, outfile, factor = _parse_io_opts(argv)
    if not infile:
        print("create_profile_from_hmmer -i <infile.hmm> [-o <out.prf>] "
              "[-factor <f>]", file=sys.stderr)
        return 4
    name = ""
    length = 0
    prof: List[List[float]] = []
    counts: List[List[float]] = []
    aa2i = {c: i for i, c in enumerate(PRF_AMINOACIDS)}
    with open(infile) as f:
        first = f.readline()
        if first.startswith("HMMER3"):
            for line in f:
                m = re.match(r"NAME\s+(\S+)", line)
                if m:
                    name = m.group(1)
                m = re.match(r"LENG\s+(\d+)", line)
                if m:
                    length = int(m.group(1))
                if line.startswith("HMM"):
                    break
            next(f)
            line = next(f)
            if line.strip().startswith("COMPO"):
                next(f)
                line = next(f)
                line = next(f)
            while True:
                if line.startswith("//"):
                    break
                toks = line.split()
                if toks and toks[0].isdigit():
                    row = [0.0] * 20
                    for a in range(20):
                        row[HHMAA2CSAA[a]] = math.exp(-float(toks[1 + a]))
                    prof.append(row)
                    crow = [0.0] * 20
                    qchar = toks[21] if len(toks) > 21 else "A"
                    crow[aa2i.get(qchar.upper(), 0)] = 1.0
                    counts.append(crow)
                    next(f)
                    next(f)
                try:
                    line = next(f)
                except StopIteration:
                    break
        elif first.startswith("HMMER"):
            pb = [0.05] * 20
            for line in f:
                m = re.match(r"NAME\s+(\S+)", line)
                if m:
                    name = m.group(1)
                m = re.match(r"LENG\s+(\d+)", line)
                if m:
                    length = int(m.group(1))
                if line.startswith("NULE"):
                    toks = line.split()[1:]
                    for a, t in enumerate(toks[:20]):
                        if t != "*":
                            pb[a] = 0.05 * 2.0 ** (float(t) / 1000.0)
                if line.startswith("HMM"):
                    break
            next(f)
            for line in f:
                if line.startswith("//"):
                    break
                toks = line.split()
                if toks and toks[0].isdigit():
                    row = [0.0] * 20
                    for a in range(20):
                        v = toks[1 + a]
                        s = -99999.0 if v == "*" else float(v)
                        row[HHMAA2CSAA[a]] = (pb[a]
                                              * 2.0 ** (s / 1000.0))
                    prof.append(row)
                    line2 = next(f)
                    crow = [0.0] * 20
                    q = line2.split()[0] if line2.split() else "A"
                    crow[aa2i.get(q[0].upper(), 0)] = 1.0
                    counts.append(crow)
                    next(f)
        else:
            print("ERROR! Unknown input format!", file=sys.stderr)
            return 1
    length = length or len(prof)
    out_counts = []
    for i in range(length):
        row = [counts[i][a] + factor * prof[i][a] for a in range(20)]
        s = sum(row) or 1.0
        row = [v / s for v in row]
        out_counts.append(["*" if v == 0 else v for v in row])
    _write_prf(outfile, name, length, out_counts, [1] * length)
    return 0


def hh_reader(argv: List[str]) -> int:
    """Print parsed hhr alignments (scripts/hh_reader.py main())."""
    from ..io.hhr import read_result

    if not argv:
        print("hh_reader <file.hhr>", file=sys.stderr)
        return 4
    for counter, r in enumerate(read_result(argv[0])):
        print(f"Alignment {counter}\t evalue: {r.evalue}"
              f"\t probability: {r.probability}")
        print(f"{r.query_id}\t{r.start[0]}\t{r.query_ali}\t{r.end[0]}")
        print(f"{r.template_id}\t{r.start[1]}\t{r.template_ali}"
              f"\t{r.end[1]}")
    return 0
