"""PDB database pipeline tools.

Equivalents of scripts/cif2fasta.py, scripts/pdbfilter.py,
scripts/pdb2fasta.pl and scripts/renumberpdb.pl, built on the mmCIF
parser in io/cif.py and the alignment helper in tools/align_util.py.
"""

from __future__ import annotations

import glob as _glob
import os
import re
import sys
import textwrap
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..io.cif import THREE_TO_ONE, parse_cif

CANONICAL = set("ACDEFGHIKLMNPQRSTVWY")
MIN_SEQ_LEN = 30


# ---------------------------------------------------------------------------
# cif2fasta (scripts/cif2fasta.py)
# ---------------------------------------------------------------------------

def _parse_poly_seq(seq: str) -> str:
    """Replace (XYZ) non-canonical residues and map unknowns to X
    (cif2fasta.py:455-494)."""
    while "(" in seq:
        a = seq.find("(")
        b = seq.find(")")
        if b < a:
            break
        res = seq[a + 1:b]
        seq = seq[:a] + THREE_TO_ONE.get(res, "X") + seq[b + 1:]
    seq = seq.replace("\n", "").replace(";", "")
    return "".join(c if c in CANONICAL else "X" for c in seq)


def _cif_entry_fasta(path: str, min_len: int = MIN_SEQ_LEN
                     ) -> Tuple[Optional[str], Optional[str]]:
    """One cif file -> (fasta text, annotation lines) or (None, None)
    (cif2fasta.py:514-686)."""
    with open(path) as f:
        block = parse_cif(f.read())
    pdb_id = block.get("_entry.id", "?")
    if pdb_id in ("?", ""):
        pdb_id = os.path.basename(path).split(".")[0].upper()

    poly = block.loop_for("_entity_poly")
    chain_to_seq: Dict[str, str] = {}
    if poly is not None:
        def _col(lp, name):
            tag = "_entity_poly." + name
            return lp.col(tag) if lp.has(tag) else None

        types = _col(poly, "type")
        seqs = _col(poly, "pdbx_seq_one_letter_code")
        strands = _col(poly, "pdbx_strand_id")
        for k in range(len(poly.rows)):
            if types and types[k] != "polypeptide(L)":
                continue
            parsed = _parse_poly_seq(seqs[k]) if seqs else ""
            chains = strands[k] if strands else "."
            for ch in chains.split(","):
                chain_to_seq[ch.strip()] = parsed
    else:
        val = block.get("_entity_poly.pdbx_seq_one_letter_code", "?")
        if val not in ("?", "") and block.get(
                "_entity_poly.type", "polypeptide(L)") == "polypeptide(L)":
            ch = block.get("_entity_poly.pdbx_strand_id", ".").split(",")[0]
            chain_to_seq[ch.strip()] = _parse_poly_seq(val)
    # drop unknown-only and too-short chains (cif2fasta.py:133-150)
    for ch in list(chain_to_seq):
        s = chain_to_seq[ch]
        if (set(s) == {"X"}) or len(s) < min_len:
            del chain_to_seq[ch]
    if not chain_to_seq:
        return None, None

    # header fields
    desc = block.get("_struct.pdbx_descriptor", "?")
    desc = ("DSC: " + " ".join(desc.replace(";", " ").split()[:5])
            if desc not in ("?", "") else "DSC: N/A")
    method = block.get("_exptl.method", "?")
    met = "MET: " + method if method not in ("?", "") else "MET: N/A"
    res = block.get("_refine.ls_d_res_high", "?")
    if res in ("?", ""):
        res = block.get("_em_3d_reconstruction.resolution", "?")
    resf = "RES: " + res if res not in ("?", "") else "RES: N/A"
    rfree = block.get("_refine.ls_R_factor_R_free", "?")
    rfr = "RFR: " + rfree if rfree not in ("?", "") else "RFR: N/A"
    org = block.get("_entity_src_gen.pdbx_gene_src_scientific_name", "?")
    if org in ("?", ""):
        org = block.get("_entity_src_nat.pdbx_organism_scientific", "?")
    orgf = "ORG: " + org.strip("'\"") if org not in ("?", "") else "ORG: N/A"

    # HET compounds appearing >= 10 times, excluding water
    # (cif2fasta.py:281-308); completeness = observed / entity length
    het_counts: Dict[str, int] = defaultdict(int)
    atom_seq: Dict[str, set] = defaultdict(set)
    lp = block.loop_for("_atom_site")
    if lp is not None:
        gi = lp.tags.index("_atom_site.group_PDB") \
            if "_atom_site.group_PDB" in lp.tags else None
        ci = lp.tags.index("_atom_site.label_comp_id") \
            if "_atom_site.label_comp_id" in lp.tags else None
        chi = lp.tags.index("_atom_site.auth_asym_id") \
            if "_atom_site.auth_asym_id" in lp.tags else (
                lp.tags.index("_atom_site.label_asym_id")
                if "_atom_site.label_asym_id" in lp.tags else None)
        si = lp.tags.index("_atom_site.label_seq_id") \
            if "_atom_site.label_seq_id" in lp.tags else None
        for row in lp.rows:
            if gi is not None and ci is not None \
                    and row[gi] == "HETATM":
                het_counts[row[ci]] += 1
            if chi is not None and si is not None and row[si] not in (
                    ".", "?"):
                atom_seq[row[chi]].add(row[si])
    hets = sorted(c for c, n in het_counts.items()
                  if n >= 10 and c != "HOH")
    het = "HET: " + ", ".join(hets) if hets else "HET: N/A"

    header = "; ".join([desc, met, resf, rfr, orgf, het]) + ";"
    fasta = []
    annos = []
    for ch in sorted(chain_to_seq):
        seq = chain_to_seq[ch]
        comp = (len(atom_seq.get(ch, ())) / float(len(seq))
                if seq else 0.0)
        fasta.append(
            ">{p}_{c} {h} CMP: {r:.2f}\n{s}\n".format(
                p=pdb_id, c=ch, h=header, r=comp,
                s="\n".join(textwrap.wrap(seq, 80))))
        annos.append("{p}_{c}\t{res}\t{rfr}\t{comp:.2f}\t{met}\n".format(
            p=pdb_id, c=ch,
            res=res if res not in ("?", "") else "N/A",
            rfr=rfree if rfree not in ("?", "") else "N/A",
            comp=comp,
            met=method if method not in ("?", "") else "N/A"))
    return "".join(fasta), "".join(annos)


def cif2fasta(argv: List[str]) -> int:
    """cif2fasta.py: mmCIF folder -> FASTA of polypeptide chains with
    DSC/MET/RES/RFR/ORG/HET/CMP header fields; -p also writes the
    pdbfilter annotations table."""
    in_dir = out_file = pdb_filter = None
    i = 0
    while i < len(argv):
        if argv[i] == "-i":
            i += 1
            in_dir = argv[i]
        elif argv[i] == "-o":
            i += 1
            out_file = argv[i]
        elif argv[i] == "-p":
            i += 1
            pdb_filter = argv[i]
        elif argv[i] in ("-c", "-s"):
            i += 1   # cores ignored (sequential); scop not supported
        i += 1
    if not in_dir or not out_file:
        print("cif2fasta -i <cif folder> -o <out.fasta> "
              "[-p <annotations.tsv>] [-c cores]", file=sys.stderr)
        return 4
    paths = sorted(_glob.glob(os.path.join(in_dir, "*.cif")))
    with open(out_file, "w") as fout:
        fanno = open(pdb_filter, "w") if pdb_filter else None
        if fanno:
            fanno.write(
                "#pdb_chain\tresolution\tr_free\tcompleteness\tmethod\n")
        n = 0
        for p in paths:
            try:
                fasta, annos = _cif_entry_fasta(p)
            except Exception as exc:
                print(f"! could not read {p}: {exc}", file=sys.stderr)
                continue
            if fasta:
                fout.write(fasta)
                n += 1
                if fanno:
                    fanno.write(annos)
        if fanno:
            fanno.close()
    print(f"Extracted {n} of {len(paths)} cif files", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# pdbfilter (scripts/pdbfilter.py)
# ---------------------------------------------------------------------------

def pdbfilter(argv: List[str]) -> int:
    """Select per-cluster representatives by best resolution, best
    R-free and best completeness (pdbfilter.py:123-201); -i/-r
    include/exclude chain lists."""
    flags = {}
    pos = []
    i = 0
    while i < len(argv):
        if argv[i] in ("-i", "--include"):
            i += 1
            flags["include"] = argv[i]
        elif argv[i] in ("-r", "--remove"):
            i += 1
            flags["remove"] = argv[i]
        elif argv[i] in ("-v", "--verbose"):
            pass
        else:
            pos.append(argv[i])
        i += 1
    if len(pos) < 4:
        print("pdbfilter <fasta> <cluster.tsv> <annotations.tsv> "
              "<out.fasta> [-i include] [-r remove]", file=sys.stderr)
        return 4
    fasta_file, cluster_file, anno_file, out_file = pos[:4]

    # fasta -> {name: full record}
    fasta_db: Dict[str, str] = {}
    name = None
    buf: List[str] = []
    with open(fasta_file) as f:
        for line in f:
            if line.startswith(">"):
                if name:
                    fasta_db[name] = "".join(buf)
                name = line[1:].split()[0]
                buf = [line]
            else:
                buf.append(line)
        if name:
            fasta_db[name] = "".join(buf)

    annotations: Dict[str, tuple] = {}
    with open(anno_file) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            ident, res, rfr, comp, method = line.rstrip("\n").split("\t")

            def _f(v):
                try:
                    return float(v)
                except ValueError:
                    return None
            annotations[ident] = (_f(res), _f(rfr), _f(comp))

    clusters: Dict[str, set] = defaultdict(set)
    with open(cluster_file) as f:
        for line in f:
            if not line.strip():
                continue
            exemplar, node = line.split()[:2]
            if node in clusters[exemplar]:
                raise RuntimeError(
                    f"{node} found twice in cluster {exemplar}")
            clusters[exemplar].add(node)

    selected = set()
    for cluster, nodes in clusters.items():
        best = {0: (float("inf"), None), 1: (float("inf"), None),
                2: (-float("inf"), None)}
        for node in nodes:
            ann = annotations.get(node)
            if ann is None:
                continue
            res, rfr, comp = ann
            if res is not None and res < best[0][0]:
                best[0] = (res, node)
            if rfr is not None and rfr < best[1][0]:
                best[1] = (rfr, node)
            if comp is not None and comp > best[2][0]:
                best[2] = (comp, node)
        found = [b[1] for b in best.values() if b[1] is not None]
        if not found:
            print(f"! Warning: Did not find any representative entry "
                  f"for cluster {cluster}.", file=sys.stderr)
        selected.update(found)

    if "include" in flags:
        with open(flags["include"]) as f:
            for line in f:
                ident = line.split("\t")[0].strip()
                if ident:
                    selected.add(ident)
    if "remove" in flags:
        with open(flags["remove"]) as f:
            for line in f:
                ident = line.split("\t")[0].strip()
                selected.discard(ident)

    with open(out_file, "w") as out:
        for ident in sorted(selected):
            if ident in fasta_db:
                out.write(fasta_db[ident])
    return 0


# ---------------------------------------------------------------------------
# pdb2fasta (scripts/pdb2fasta.pl)
# ---------------------------------------------------------------------------

def pdb2fasta(argv: List[str]) -> int:
    """SEQRES records of globbed PDB files -> FASTA; -all keeps
    redundant chains, -u <old.fas> skips pdbids present in the old
    file (pdb2fasta.pl)."""
    allseqs = "-all" in argv
    oldfile = None
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "-u":
            i += 1
            oldfile = argv[i]
        elif argv[i].startswith("-"):
            if argv[i] in ("-v", "-t", "-scop", "-dali"):
                i += 1
        else:
            rest.append(argv[i])
        i += 1
    if len(rest) < 2:
        print("pdb2fasta '<pdb-fileglob>' <out.fas> [-all] "
              "[-u old.fas]", file=sys.stderr)
        return 4
    old_ids = set()
    if oldfile and os.path.exists(oldfile):
        with open(oldfile) as f:
            for line in f:
                if line.startswith(">"):
                    old_ids.add(line[1:7].strip().split("_")[0].lower())
    seen_seq: Dict[str, int] = {}
    records: List[str] = []
    equiv: List[List[str]] = []
    for path in sorted(_glob.glob(rest[0])):
        pdbid = re.sub(r"^pdb", "",
                       os.path.basename(path).split(".")[0]).lower()
        if pdbid in old_ids:
            continue
        seqres: Dict[str, List[str]] = defaultdict(list)
        descript = ""
        resolution = "N/A"
        with open(path) as f:
            for line in f:
                if line.startswith("SEQRES"):
                    chain = line[11].strip()
                    seqres[chain] += line[19:].split()
                elif line.startswith("HEADER"):
                    descript = line[10:50].strip()
                elif line.startswith("REMARK   2 RESOLUTION"):
                    m = re.search(r"(\d+\.\d+)", line)
                    if m:
                        resolution = m.group(1)
        for chain in sorted(seqres):
            seq = "".join(THREE_TO_ONE.get(r, "X") for r in seqres[chain])
            if len(seq) < MIN_SEQ_LEN // 3:
                continue
            name = f"{pdbid}_{chain}" if chain else pdbid
            if not allseqs and seq in seen_seq:
                equiv[seen_seq[seq]].append(name)
                continue
            seen_seq[seq] = len(records)
            equiv.append([])
            records.append(
                ">%-6.6s %s; %s A\n%s\n" % (
                    name, descript, resolution,
                    "\n".join(textwrap.wrap(seq, 80))))
    with open(rest[1], "w") as out:
        for k, rec in enumerate(records):
            if equiv[k]:
                head, body = rec.split("\n", 1)
                rec = head + " PDB:" + " ".join(equiv[k]) + "\n" + body
            out.write(rec)
    print(f"Wrote {len(records)} sequences", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# renumberpdb (scripts/renumberpdb.pl)
# ---------------------------------------------------------------------------

_AA3 = {v: k for k, v in THREE_TO_ONE.items()}


def _atom_chain_seq(lines: List[str], chain: str
                    ) -> Tuple[str, List[int]]:
    """Sequence + line indices of first-atom-per-residue from ATOM
    records (MSE HETATMs count as MET, renumberpdb.pl)."""
    seq = []
    starts = []
    last = None
    for k, line in enumerate(lines):
        rec = line[:6]
        if rec not in ("ATOM  ", "HETATM"):
            continue
        if rec == "HETATM" and line[17:20] != "MSE":
            continue
        ch = line[21]
        if chain and ch != chain:
            continue
        resnum = line[22:27]
        if resnum != last:
            last = resnum
            res3 = "MET" if line[17:20] == "MSE" else line[17:20]
            seq.append(THREE_TO_ONE.get(res3, "X"))
            starts.append(k)
    return "".join(seq), starts


def renumberpdb(argv: List[str]) -> int:
    """Renumber a PDB chain so residue indices match an input
    FASTA/A3M sequence (renumberpdb.pl): the query is aligned to the
    ATOM-record sequence and columns 23-26 are rewritten; MSE HETATM
    becomes ATOM MET."""
    outfile = None
    pdbdir = "."
    pdbfile = None
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "-o":
            i += 1
            outfile = argv[i]
        elif argv[i] == "-pdb":
            i += 1
            pdbdir = argv[i]
        elif argv[i] == "-pdbfile":
            i += 1
            pdbfile = argv[i]
        else:
            rest.append(argv[i])
        i += 1
    if not rest:
        print("renumberpdb [-o outfile] [-pdb <pdbdir>] "
              "[-pdbfile <file.pdb>] <infile.a3m>", file=sys.stderr)
        return 4
    infile = rest[0]
    if len(rest) > 1 and outfile is None:
        outfile = rest[1]

    name = ""
    seq = []
    with open(infile) as f:
        for line in f:
            if line.startswith(">"):
                if seq:
                    break
                name = line[1:].split()[0] if line[1:].split() else ""
            elif not line.startswith("#"):
                seq.append(line.strip())
    aaq = re.sub(r"[.\-]", "", "".join(seq)).upper()
    if not aaq:
        print(f"ERROR: no sequence found in {infile}", file=sys.stderr)
        return 1

    # identifier -> pdb file + chain (d1hz4a_, 1hz4_A, 1hz4A_1 styles)
    chain = ""
    pdbid = ""
    m = re.match(r"^d(\d[a-z0-9]{3})([a-z0-9._])", name, re.I)
    if m:
        pdbid, chain = m.group(1), m.group(2)
        chain = "" if chain in "._" else chain.upper()
    else:
        m = re.match(r"^(\d[A-Za-z0-9]{3})_?([A-Za-z0-9]?)", name)
        if m:
            pdbid, chain = m.group(1), m.group(2).upper()
    if pdbfile is None:
        for cand in (f"{pdbid.lower()}.pdb", f"pdb{pdbid.lower()}.ent",
                     f"{pdbid.upper()}.pdb"):
            p = os.path.join(pdbdir, cand)
            if os.path.exists(p):
                pdbfile = p
                break
    if pdbfile is None or not os.path.exists(pdbfile):
        print(f"ERROR: no pdb file found for {name} in {pdbdir}",
              file=sys.stderr)
        return 1
    if outfile is None:
        outfile = re.sub(r"\.\w+$", "", infile) + ".pdb"

    with open(pdbfile) as f:
        lines = f.read().splitlines()
    aseq, starts = _atom_chain_seq(lines, chain)
    if not aseq:
        print(f"ERROR: chain '{chain}' not found in {pdbfile}",
              file=sys.stderr)
        return 1

    from .align_util import align_identity

    _score, qpos, tpos = align_identity(aaq, aseq)
    # residue index in query for each atom-seq residue
    newnum: Dict[int, int] = {t - 1: q for q, t in zip(qpos, tpos)}

    out_lines = []
    res_idx = -1
    last = None
    for k, line in enumerate(lines):
        rec = line[:6]
        if rec not in ("ATOM  ", "HETATM", "TER   "):
            out_lines.append(line)
            continue
        is_mse = rec == "HETATM" and line[17:20] == "MSE"
        if rec == "HETATM" and not is_mse:
            out_lines.append(line)
            continue
        if chain and len(line) > 21 and line[21] != chain \
                and rec != "TER   ":
            continue
        if rec == "TER   ":
            out_lines.append(line)
            continue
        resnum = line[22:27]
        if resnum != last:
            last = resnum
            res_idx += 1
        if res_idx not in newnum:
            continue
        if is_mse:
            line = "ATOM  " + line[6:17] + "MET" + line[20:]
        line = line[:22] + "%4i" % newnum[res_idx] + " " + line[27:]
        out_lines.append(line)
    with open(outfile, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    return 0
