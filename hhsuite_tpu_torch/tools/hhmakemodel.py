"""hhmakemodel: build a homology-modeling alignment from .hhr results.

Equivalent of scripts/hhmakemodel.py (2400 LoC, pdbx-based) and the
alignment-only modes of scripts/hhmakemodel.pl: select template hits
from a .hhr file, assemble a master-slave multiple alignment glued on
the query, and emit it as FASTA / A3M / PIR — the PIR carrying
MODELLER ``structureX`` metadata when a CIF folder is supplied, along
with renumbered per-template CIF files trimmed to the aligned region
(the reference's compare_with_cifs + renumbering,
scripts/hhmakemodel.py:701-2278).

Hit selection mirrors the reference options: ``-m i j k`` picks hit
indices, ``-e X`` keeps hits with E-value <= X, ``-r R`` drops hits
contributing fewer than R * query_length aligned residues
(scripts/hhmakemodel.py:2313-2320).

Grid semantics: query match positions form the master columns;
template insertions (``-`` in the hit's Q row) get private columns
anchored after their preceding query position, so insertions of
different templates are never aligned to each other — same outcome as
the reference's process_template_grid gap surgery
(scripts/hhmakemodel.py:673-700).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..io.hhr import hhr_alignment, read_result


@dataclass
class _TemplateRow:
    hit: hhr_alignment
    cells: Dict[Tuple[int, int, int], str] = field(default_factory=dict)
    # key = (query_pos, ins_serial, hit_rank); ins_serial 0 => match col

    pdb_code: str = ""
    chain: str = ""


def _walk_pairs(hit: hhr_alignment, rank: int) -> Dict[Tuple[int, int, int],
                                                       str]:
    """Map alignment columns to grid cells keyed by query anchor."""
    cells: Dict[Tuple[int, int, int], str] = {}
    qpos = hit.start[0] - 1
    ins = 0
    for qc, tc in zip(hit.query_ali, hit.template_ali):
        if qc != "-":
            qpos += 1
            ins = 0
            if tc != "-":
                cells[(qpos, 0, 0)] = tc
        else:
            if tc != "-":
                ins += 1
                cells[(qpos, ins, rank)] = tc
    return cells


def _template_id_to_pdb(template_id: str) -> Tuple[str, str]:
    """'1ABC_D' -> ('1abc', 'D'); fallbacks match the reference's
    template_id_to_pdb heuristics (scripts/hhmakemodel.py:544-565)."""
    tid = template_id
    if "_" in tid:
        code, chain = tid.rsplit("_", 1)
        return code.lower(), chain
    if len(tid) == 5:
        return tid[:4].lower(), tid[4]
    return tid.lower(), "A"


def build_grid(results: List[hhr_alignment],
               pick: Optional[List[int]] = None,
               e_thresh: Optional[float] = None,
               res_ratio: Optional[float] = None):
    """Select hits and build (columns, query_row, template_rows)."""
    hits: List[Tuple[int, hhr_alignment]] = []
    for no, r in enumerate(results, 1):
        if pick and no not in pick:
            continue
        if e_thresh is not None and r.evalue is not None \
                and r.evalue > e_thresh:
            continue
        if res_ratio is not None and r.query_length:
            contributed = sum(1 for c in r.template_ali if c != "-")
            if contributed < res_ratio * r.query_length:
                continue
        hits.append((no, r))
    if not hits:
        raise SystemExit("hhmakemodel: no hits selected")

    rows: List[_TemplateRow] = []
    qres: Dict[int, str] = {}
    for rank, (no, r) in enumerate(hits, 1):
        row = _TemplateRow(hit=r, cells=_walk_pairs(r, rank))
        row.pdb_code, row.chain = _template_id_to_pdb(r.template_id)
        rows.append(row)
        qpos = r.start[0] - 1
        for qc in r.query_ali:
            if qc != "-":
                qpos += 1
                qres.setdefault(qpos, qc)

    L = hits[0][1].query_length or max(qres, default=0)
    # master column list: (qpos, ins_serial, rank)
    columns: List[Tuple[int, int, int]] = []
    ins_keys = sorted(k for row in rows for k in row.cells if k[1] > 0)
    ins_by_anchor: Dict[int, List[Tuple[int, int, int]]] = {}
    for k in ins_keys:
        ins_by_anchor.setdefault(k[0], []).append(k)
    for qpos in range(1, L + 1):
        columns.append((qpos, 0, 0))
        for k in ins_by_anchor.get(qpos, []):
            columns.append(k)

    query_row = "".join(
        (qres.get(q, "X") if s == 0 else "-") for (q, s, _r) in columns)
    return columns, query_row, rows


def render_row(columns, row: _TemplateRow) -> str:
    return "".join(row.cells.get(c if c[1] else (c[0], 0, 0), "-")
                   for c in columns)


def _trim_common_gaps(query_row: str, t_rows: List[str]):
    keep = [i for i, qc in enumerate(query_row)
            if qc not in "-X" or any(t[i] != "-" for t in t_rows)]
    sel = lambda s: "".join(s[i] for i in keep)
    return sel(query_row), [sel(t) for t in t_rows]


def write_fasta(path, query_name, query_row, rows, rendered):
    with open(path, "w") as f:
        f.write(f">{query_name}\n{query_row}\n")
        for row, seq in zip(rows, rendered):
            f.write(f">{row.hit.template_id}\n{seq}\n")


def write_pir(path, query_name, query_row, rows, rendered,
              cif_ranges: Optional[Dict[str, Tuple[int, int]]] = None):
    """PIR for MODELLER (reference PIR layout,
    scripts/hhmakemodel.py:2293-2298 + structure metadata rows)."""
    with open(path, "w") as f:
        f.write(f">P1;{query_name}\n")
        f.write(f"sequence:{query_name}:1::{len(query_row)}::::0.00:0.00\n")
        f.write(query_row + "*\n\n")
        for row, seq in zip(rows, rendered):
            name = f"{row.pdb_code}_{row.chain}"
            if cif_ranges and name in cif_ranges:
                s, e = cif_ranges[name]
            else:
                s, e = row.hit.start[1], row.hit.end[1]
            f.write(f">P1;{name}\n")
            f.write(f"structureX:{name}:{s}:{row.chain}:{e}:"
                    f"{row.chain}::::\n")
            f.write(seq + "*\n\n")


def process_cifs(cif_dir: str, out_dir: str, rows: List[_TemplateRow],
                 verbose: bool = False) -> Dict[str, Tuple[int, int]]:
    """Trim + renumber template CIFs to the aligned template range.

    Returns {pdbid_chain: (new_start, new_end)} for the PIR metadata.
    Missing CIFs are reported and skipped (alignment rows remain).
    """
    from ..io.cif import atom_records, parse_cif, write_atom_block

    os.makedirs(out_dir, exist_ok=True)
    ranges: Dict[str, Tuple[int, int]] = {}
    for row in rows:
        name = f"{row.pdb_code}_{row.chain}"
        src = None
        for cand in (f"{row.pdb_code}.cif", f"{row.pdb_code.upper()}.cif"):
            p = os.path.join(cif_dir, cand)
            if os.path.exists(p):
                src = p
                break
        if src is None:
            print(f"hhmakemodel: no CIF for {name} in {cif_dir}",
                  file=sys.stderr)
            continue
        with open(src) as f:
            block = parse_cif(f.read())
        recs = atom_records(block)
        t_start, t_end = row.hit.start[1], row.hit.end[1]
        kept = []
        seen_label = set()
        seq_counter = 0
        renum: Dict[Tuple[str, str], int] = {}
        for r in recs:
            ch = r["auth_asym_id"] if r["auth_asym_id"] != "?" \
                else r["label_asym_id"]
            if ch != row.chain or r["group_PDB"] != "ATOM":
                continue
            if r["pdbx_PDB_model_num"] not in ("?", "1"):
                continue
            key = (r["auth_seq_id"], r["pdbx_PDB_ins_code"])
            if key not in renum:
                seq_counter += 1
                renum[key] = seq_counter
            seq_id = renum[key]
            if not (t_start <= seq_id <= t_end):
                continue
            r2 = dict(r)
            new_id = seq_id - t_start + 1
            r2["auth_seq_id"] = str(new_id)
            r2["label_seq_id"] = str(new_id)
            r2["auth_asym_id"] = row.chain
            kept.append(r2)
            seen_label.add(new_id)
        if not kept:
            print(f"hhmakemodel: chain {row.chain} of {src} has no atoms "
                  f"in template range {t_start}-{t_end}", file=sys.stderr)
            continue
        ranges[name] = (1, max(seen_label))
        dst = os.path.join(out_dir, f"{name}.cif")
        with open(dst, "w") as f:
            f.write(write_atom_block(name, kept))
        if verbose:
            print(f"hhmakemodel: wrote {dst} ({len(kept)} atoms)",
                  file=sys.stderr)
    return ranges


def main(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="hhmakemodel",
        description="Build a MODELLER alignment from hhsearch/hhblits "
                    "results")
    ap.add_argument("-i", dest="input", required=True,
                    help=".hhr results file")
    ap.add_argument("-fas", help="output master-slave alignment as FASTA")
    ap.add_argument("-a3m", help="output alignment as A3M")
    ap.add_argument("-pir", help="output alignment as MODELLER PIR")
    ap.add_argument("-cifs", help="folder with template CIF files")
    ap.add_argument("-ocifs", help="folder for renumbered template CIFs")
    ap.add_argument("-m", nargs="+", type=int,
                    help="pick hits by index (1-based)")
    ap.add_argument("-e", type=float, help="maximum E-value")
    ap.add_argument("-r", type=float,
                    help="min aligned-residue ratio vs query length")
    ap.add_argument("-v", action="store_true", help="verbose")
    a = ap.parse_args(argv)

    try:
        results = read_result(a.input)
    except OSError as e:
        raise SystemExit(f"hhmakemodel: cannot read '{a.input}': "
                         f"{e.strerror}")
    if not results:
        raise SystemExit(f"hhmakemodel: no hits in {a.input}")
    query_name = results[0].query_id
    columns, query_row, rows = build_grid(results, a.m, a.e, a.r)
    rendered = [render_row(columns, row) for row in rows]
    query_row, rendered = _trim_common_gaps(query_row, rendered)

    cif_ranges = None
    if a.cifs:
        cif_ranges = process_cifs(a.cifs, a.ocifs or ".", rows, a.v)

    if a.fas:
        write_fasta(a.fas, query_name, query_row, rows, rendered)
    if a.a3m:
        # A3M: keep query match columns upper, insertions lower-case
        with open(a.a3m, "w") as f:
            f.write(f">{query_name}\n{query_row.replace('-', '')}\n")
            for row, seq in zip(rows, rendered):
                a3m_seq = "".join(
                    (c.lower() if qc == "-" and c != "-" else c)
                    for qc, c in zip(query_row, seq))
                a3m_seq = "".join(
                    c for qc, c in zip(query_row, a3m_seq)
                    if not (qc == "-" and c == "-"))
                f.write(f">{row.hit.template_id}\n{a3m_seq}\n")
    if a.pir:
        write_pir(a.pir, query_name, query_row, rows, rendered, cif_ranges)
    if not (a.fas or a.a3m or a.pir):
        ap.error("no output requested (-fas/-a3m/-pir)")
    return 0
