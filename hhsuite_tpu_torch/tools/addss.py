"""addss: add PSIPRED secondary-structure prediction to an MSA
(equivalent of scripts/addss.pl).

The reference pipeline is reformat -> hhfilter -neff 7 -> legacy
blastpgp/makemat -> psipred -> psipass2, inserting >ss_pred/>ss_conf
rows at the top of the a3m (addss.pl:140-260).  Here the PSSM .mtx fed
to PSIPRED is generated directly from this package's own profile engine
(no legacy BLAST needed); the PSIPRED binaries themselves are external
and are located through $PSIPRED_DIR or $PATH.  When they are absent, a
precomputed PSIPRED output can be supplied with -horiz.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional, Tuple

# mtx rows are 28 columns in NCBI aa order (makemat/psipred convention)
_NCBI_ORDER = "-ABCDEFGHIKLMNPQRSTVWXYZU*"
_HH_AA = "ACDEFGHIKLMNPQRSTVWY"


def make_mtx(a3m_text: str, neff_target: float = 7.0) -> Tuple[str, str]:
    """(mtx text, query sequence): PSSM log-odds x100 from the profile
    engine (replaces blastpgp+makemat in addss.pl:200-228)."""
    import numpy as np

    from ..constants import Parameters
    from ..core.alignment import Alignment
    from ..core.profile import frequencies_and_transitions
    from ..core.hmm import HMM
    from ..matrices import get_substitution_matrix

    par = Parameters.hhmake_defaults() if hasattr(
        Parameters, "hhmake_defaults") else Parameters.hhblits_defaults()
    mats = get_substitution_matrix(par.matrix)
    ali = Alignment.from_a3m_text(a3m_text, infile="addss", mark=par.mark,
                                  maxseq=par.maxseq)
    ali.compress(M=1)
    if neff_target:
        ali.filter_neff(par.wg, par.mark, par.cons, par.showcons,
                        par.max_seqid, par.coverage, neff_target,
                        mats.pb, mats.S, mats.Sim)
    q = HMM()
    frequencies_and_transitions(ali, q, par.wg, par.mark, par.cons,
                                par.showcons, mats.pb, mats.Sim)
    L = q.L
    seq = "".join(q.seq[q.nfirst][1:L + 1]).upper() \
        if getattr(q, "seq", None) else ""
    if len(seq) != L:
        seq = re.sub(r"[a-z.\-]", "",
                     "".join(ali.seqs[ali.kfirst][1:])).upper()[:L]
    f = np.asarray(q.f[1:L + 1], dtype=np.float64)       # (L, 20)
    pb = np.asarray(mats.pb, dtype=np.float64)[:20]
    odds = np.log(np.clip(f, 1e-8, None) / pb) * 100.0
    aa_index = {c: i for i, c in enumerate(_HH_AA)}
    lines = [str(L), seq]
    # makemat header filler (psipred skips to the score rows)
    lines += ["2.670000e-03", "4.100000e-02", "-3.194183e+00",
              "1.400000e-01", "2.670000e-03", "4.100000e-02",
              "-3.179142e+00", "4.600000e-01", "3.176060e-03",
              "1.339561e-01", "-2.010243e+00", "4.012145e-01"]
    for i in range(L):
        row = []
        for c in _NCBI_ORDER:
            if c in aa_index:
                row.append(str(int(round(odds[i, aa_index[c]]))))
            elif c == "*":
                row.append("-32768")
            else:
                row.append("-32768" if c in "-U*" else "-100")
        lines.append("  ".join(row))
    return "\n".join(lines) + "\n", seq


def _find_psipred() -> Optional[Tuple[str, str, str]]:
    """(psipred, psipass2, datadir) or None."""
    base = os.environ.get("PSIPRED_DIR", "")
    cands = [os.path.join(base, "bin")] if base else []
    psipred = None
    for d in cands:
        p = os.path.join(d, "psipred")
        if os.path.exists(p):
            psipred = p
    psipred = psipred or shutil.which("psipred")
    if not psipred:
        return None
    psipass2 = (os.path.join(os.path.dirname(psipred), "psipass2")
                if os.path.exists(os.path.join(os.path.dirname(psipred),
                                               "psipass2"))
                else shutil.which("psipass2"))
    data = (os.path.join(base, "data") if base
            else os.path.join(os.path.dirname(os.path.dirname(psipred)),
                              "data"))
    return psipred, psipass2 or "", data


def parse_horiz(text: str) -> Tuple[str, str]:
    """PSIPRED .horiz output -> (ss_pred, ss_conf)
    (addss.pl:235-252)."""
    pred = []
    conf = []
    for line in text.splitlines():
        m = re.match(r"^Conf:\s+(\S+)", line)
        if m:
            conf.append(m.group(1))
        m = re.match(r"^Pred:\s+(\S+)", line)
        if m:
            pred.append(m.group(1))
    ss_pred = "".join(pred)
    ss_conf = re.sub(r"[^0-9]", "0", "".join(conf))
    return ss_pred, ss_conf


def _wrap(s: str, width: int = 100) -> str:
    return "\n".join(s[i:i + width] for i in range(0, len(s), width))


def insert_ss(a3m_text: str, ss_pred: str, ss_conf: str) -> str:
    """Place >ss_pred/>ss_conf after the leading '#' line, replacing any
    existing ones (addss.pl:253-259)."""
    lines = a3m_text.splitlines()
    out: List[str] = []
    i = 0
    if lines and lines[0].startswith("#"):
        out.append(lines[0])
        i = 1
    out.append(">ss_pred PSIPRED predicted secondary structure")
    out.append(_wrap(ss_pred))
    out.append(">ss_conf PSIPRED confidence values")
    out.append(_wrap(ss_conf))
    skip = False
    for line in lines[i:]:
        if line.startswith(">ss_pred") or line.startswith(">ss_conf"):
            skip = True
            continue
        if line.startswith(">"):
            skip = False
        if not skip:
            out.append(line)
    return "\n".join(out) + "\n"


def addss(argv: List[str]) -> int:
    infile = outfile = horiz = None
    rest: List[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "-i":
            i += 1
            infile = argv[i]
        elif argv[i] == "-o":
            i += 1
            outfile = argv[i]
        elif argv[i] == "-horiz":
            i += 1
            horiz = argv[i]
        elif argv[i] in ("-a3m", "-fas", "-clu", "-sto", "-v"):
            pass
        else:
            rest.append(argv[i])
        i += 1
    if infile is None and rest:
        infile = rest.pop(0)
    if outfile is None and rest:
        outfile = rest.pop(0)
    if not infile:
        print("addss -i <in.a3m> [-o <out.a3m>] [-horiz <psipred.horiz>]",
              file=sys.stderr)
        return 4
    outfile = outfile or infile
    with open(infile) as f:
        text = f.read()

    if horiz:
        with open(horiz) as f:
            ss_pred, ss_conf = parse_horiz(f.read())
    else:
        found = _find_psipred()
        if not found:
            print("ERROR: psipred binaries not found (set $PSIPRED_DIR "
                  "or $PATH, or pass -horiz <file> with a precomputed "
                  "PSIPRED output)", file=sys.stderr)
            return 2
        psipred, psipass2, datadir = found
        mtx, _seq = make_mtx(text)
        with tempfile.TemporaryDirectory() as tmp:
            mtx_path = os.path.join(tmp, "q.mtx")
            with open(mtx_path, "w") as f:
                f.write(mtx)
            weights = [os.path.join(datadir, w) for w in
                       ("weights.dat", "weights.dat2", "weights.dat3")]
            ss = subprocess.run([psipred, mtx_path] + weights,
                                capture_output=True, text=True)
            if ss.returncode != 0:
                print(ss.stderr, file=sys.stderr)
                return 1
            ss_path = os.path.join(tmp, "q.ss")
            with open(ss_path, "w") as f:
                f.write(ss.stdout)
            horiz_path = os.path.join(tmp, "q.horiz")
            ss2_path = os.path.join(tmp, "q.ss2")
            hz = subprocess.run(
                [psipass2, os.path.join(datadir, "weights_p2.dat"),
                 "1", "1.0", "1.0", ss2_path, ss_path],
                capture_output=True, text=True)
            if hz.returncode != 0:
                print(hz.stderr, file=sys.stderr)
                return 1
            with open(horiz_path, "w") as f:
                f.write(hz.stdout)
            ss_pred, ss_conf = parse_horiz(hz.stdout)

    if not ss_pred:
        print("ERROR: no secondary structure predicted", file=sys.stderr)
        return 1
    with open(outfile, "w") as f:
        f.write(insert_ss(text, ss_pred, ss_conf))
    return 0
