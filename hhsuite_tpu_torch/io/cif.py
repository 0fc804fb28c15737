"""Minimal mmCIF reader/writer for the structure-facing tools.

Replaces the vendored ``pdbx`` dependency of the reference's
scripts/hhmakemodel.py and scripts/cif2fasta.py with a small in-house
layer: tokenizer for CIF values (quoted strings, ``;``-delimited text
fields), ``_atom_site`` loop extraction, chain sequence recovery, and
atom-loop writing.  Only the categories those tools touch are modeled.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# 3-letter -> 1-letter, incl. the non-canonical conversions of
# scripts/hhmakemodel.py:387-496 (MSE->M, SEC/CSE->C quirks etc.)
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    # common modified residues
    "MSE": "M", "MLY": "K", "CSO": "C", "SEP": "S", "TPO": "T",
    "PTR": "Y", "HYP": "P", "KCX": "K", "CME": "C", "CSD": "C",
    "SEC": "C", "PYL": "K", "LLP": "K", "M3L": "K", "OCS": "C",
    "FME": "M", "CSX": "C", "SME": "M", "NEP": "H", "ALY": "K",
    "MLZ": "K", "4BF": "F", "PCA": "E", "DAL": "A", "DSN": "S",
}


def _tokenize(line: str) -> List[str]:
    """Split one CIF data line into values, honoring '...'/"..." quoting."""
    out = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in " \t":
            i += 1
            continue
        if c in "'\"":
            j = i + 1
            while j < n and not (line[j] == c
                                 and (j + 1 == n or line[j + 1] in " \t")):
                j += 1
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            out.append(line[i:j])
            i = j
    return out


@dataclass
class CifLoop:
    tags: List[str]
    rows: List[List[str]]

    def col(self, tag: str) -> List[str]:
        i = self.tags.index(tag)
        return [r[i] for r in self.rows]

    def has(self, tag: str) -> bool:
        return tag in self.tags


@dataclass
class CifBlock:
    name: str = ""
    items: Dict[str, str] = field(default_factory=dict)    # _tag -> value
    loops: List[CifLoop] = field(default_factory=list)

    def loop_for(self, category: str) -> Optional[CifLoop]:
        """First loop whose tags start with e.g. '_atom_site.'."""
        pre = category if category.endswith(".") else category + "."
        for lp in self.loops:
            if lp.tags and lp.tags[0].startswith(pre):
                return lp
        return None

    def get(self, tag: str, default: str = "?") -> str:
        if tag in self.items:
            return self.items[tag]
        # single-row loop also answers item queries
        cat = tag.rsplit(".", 1)[0]
        lp = self.loop_for(cat)
        if lp is not None and lp.has(tag) and len(lp.rows) == 1:
            return lp.col(tag)[0]
        return default


def parse_cif(text: str) -> CifBlock:
    """Parse the first data block: items, loops, ';' text fields."""
    block = CifBlock()
    lines = text.splitlines()
    i, n = 0, len(lines)

    def read_semicolon_value(idx):
        # lines[idx] starts with ';'
        buf = [lines[idx][1:]]
        idx += 1
        while idx < n and not lines[idx].startswith(";"):
            buf.append(lines[idx])
            idx += 1
        return "\n".join(buf).strip(), idx + 1

    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
        elif line.startswith("data_"):
            if block.name:
                break                      # only first block
            block.name = line[5:]
            i += 1
        elif line.startswith("loop_"):
            i += 1
            tags = []
            while i < n and lines[i].strip().startswith("_"):
                tags.append(lines[i].strip().split()[0])
                i += 1
            rows: List[List[str]] = []
            pending: List[str] = []
            while i < n:
                s = lines[i].strip()
                if not s or s.startswith("#"):
                    i += 1
                    if not s:
                        continue
                    break
                if s.startswith("_") or s.startswith("loop_") \
                        or s.startswith("data_"):
                    break
                if s.startswith(";"):
                    val, i = read_semicolon_value(i)
                    pending.append(val)
                else:
                    pending.extend(_tokenize(lines[i]))
                    i += 1
                while len(pending) >= len(tags):
                    rows.append(pending[:len(tags)])
                    pending = pending[len(tags):]
            block.loops.append(CifLoop(tags=tags, rows=rows))
        elif line.startswith("_"):
            parts = _tokenize(line)
            tag = parts[0]
            if len(parts) > 1:
                block.items[tag] = parts[1]
                i += 1
            elif i + 1 < n and lines[i + 1].startswith(";"):
                val, i = read_semicolon_value(i + 1)
                block.items[tag] = val
            else:
                block.items[tag] = lines[i + 1].strip() if i + 1 < n else "?"
                i += 2
        else:
            i += 1
    return block


_ATOM_TAGS = [
    "_atom_site.group_PDB", "_atom_site.id", "_atom_site.type_symbol",
    "_atom_site.label_atom_id", "_atom_site.label_alt_id",
    "_atom_site.label_comp_id", "_atom_site.label_asym_id",
    "_atom_site.label_entity_id", "_atom_site.label_seq_id",
    "_atom_site.pdbx_PDB_ins_code", "_atom_site.Cartn_x",
    "_atom_site.Cartn_y", "_atom_site.Cartn_z", "_atom_site.occupancy",
    "_atom_site.B_iso_or_equiv", "_atom_site.auth_seq_id",
    "_atom_site.auth_asym_id", "_atom_site.pdbx_PDB_model_num",
]


def atom_records(block: CifBlock) -> List[Dict[str, str]]:
    lp = block.loop_for("_atom_site")
    if lp is None:
        return []
    idx = {t: (lp.tags.index(t) if t in lp.tags else None)
           for t in _ATOM_TAGS}
    recs = []
    for row in lp.rows:
        recs.append({t.split(".", 1)[1]: (row[j] if j is not None else "?")
                     for t, j in idx.items()})
    return recs


def chain_sequence(recs: List[Dict[str, str]], chain: str
                   ) -> Tuple[str, List[str]]:
    """One-letter sequence of a chain from its CA atoms (model 1), with
    the matching auth_seq_id labels.  Prefers auth_asym_id naming (the
    PDB chain letter), falling back to label_asym_id."""
    seq, nums = [], []
    seen = set()
    for r in recs:
        if r["group_PDB"] != "ATOM" and r["label_comp_id"] not in THREE_TO_ONE:
            continue
        ch = r["auth_asym_id"] if r["auth_asym_id"] != "?" \
            else r["label_asym_id"]
        if ch != chain:
            continue
        if r["pdbx_PDB_model_num"] not in ("?", "1"):
            continue
        if r["label_atom_id"] != "CA":
            continue
        if r["label_alt_id"] not in (".", "?", "A"):
            continue
        key = (r["auth_seq_id"], r["pdbx_PDB_ins_code"])
        if key in seen:
            continue
        seen.add(key)
        seq.append(THREE_TO_ONE.get(r["label_comp_id"], "X"))
        nums.append(r["auth_seq_id"])
    return "".join(seq), nums


def write_atom_block(name: str, recs: List[Dict[str, str]]) -> str:
    """Serialize records as a single-loop mmCIF data block."""
    out = [f"data_{name}", "#", "loop_"]
    out.extend(_ATOM_TAGS)
    for r in recs:
        vals = []
        for t in _ATOM_TAGS:
            v = r.get(t.split(".", 1)[1], "?")
            vals.append(f"'{v}'" if (" " in v or v == "") else v)
        out.append(" ".join(vals))
    out.append("#")
    return "\n".join(out) + "\n"
