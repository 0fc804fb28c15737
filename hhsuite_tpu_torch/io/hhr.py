"""Parser for .hhr result files (hhblits/hhsearch/hhalign -o output).

Drop-in for the reference's scripts/hh_reader.py public API: the
``hhr_alignment`` namedtuple, ``parse_result(lines)`` and
``read_result(path)`` (scripts/hh_reader.py:17-184).  Only ``Q``/``T``
sequence rows of the query/template themselves are collected;
ss_dssp/ss_pred/Consensus rows are skipped.  A hit's Q/T blocks may be
split across several paragraph chunks; starts take the min and ends the
max across chunks, matching the reference parser.
"""

from __future__ import annotations

from collections import namedtuple
from typing import List

hhr_alignment = namedtuple(
    "hhr_alignment",
    ["query_id", "query_length", "query_neff",
     "template_id", "template_length", "template_info",
     "template_neff", "query_ali", "template_ali",
     "start", "end", "probability", "evalue", "score",
     "aligned_cols", "identity", "similarity", "sum_probs"])


class HHRFormatError(Exception):
    def __init__(self, value):
        self.value = "ERROR: " + value

    def __str__(self):
        return repr(self.value)


_SKIP_TAGS = {"ss_dssp", "ss_pred", "Consensus"}


def _int_field(tok: str, what: str) -> int:
    try:
        return int(tok.replace("(", "").replace(")", ""))
    except ValueError:
        raise HHRFormatError(
            f"Converting failure of {what} ({tok})")


def parse_result(lines) -> List[hhr_alignment]:
    results: List[hhr_alignment] = []

    query_id = query_length = query_neff = None
    state = {}

    def flush():
        if state.get("template_id") is not None \
                and state.get("q_start") is not None:
            results.append(hhr_alignment(
                query_id, query_length, query_neff,
                state["template_id"], state.get("t_len"),
                state.get("template_info"), state.get("t_neff"),
                "".join(state.get("q_seq", [])),
                "".join(state.get("t_seq", [])),
                (state.get("q_start"), state.get("t_start")),
                (state.get("q_end"), state.get("t_end")),
                state.get("prob"), state.get("evalue"), state.get("score"),
                state.get("cols"), state.get("ident"), state.get("sim"),
                state.get("sumprobs")))

    in_ali = False
    for line in lines:
        if line.startswith("Query"):
            query_id = line.split()[1]
        elif line.startswith("Match_columns"):
            query_length = int(line.split()[1])
        elif line.startswith("Neff") and query_neff is None:
            query_neff = float(line.split()[1])
        elif in_ali and (line.startswith("No") or line.startswith("Done!")):
            flush()
            state = {}
        elif line.startswith("Probab"):
            tok = line.split()
            state["prob"] = float(tok[0].split("=")[1])
            state["evalue"] = float(tok[1].split("=")[1])
            state["score"] = float(tok[2].split("=")[1])
            state["cols"] = int(tok[3].split("=")[1])
            state["ident"] = float(
                tok[4].split("=")[1].replace("%", "")) / 100.0
            state["sim"] = float(tok[5].split("=")[1])
            state["sumprobs"] = float(tok[6].split("=")[1])
            if len(tok) > 7:
                state["t_neff"] = float(tok[7].split("=")[1])
        elif line.startswith(">"):
            in_ali = True
            state["template_id"] = line[1:].split()[0]
            state["template_info"] = line
        elif line.startswith("Q "):
            tok = line.split()
            if tok[1] in _SKIP_TAGS:
                continue
            s = _int_field(tok[2], "start index of query alignment")
            e = _int_field(tok[4], "end index of query alignment")
            state["q_start"] = min(state.get("q_start", s), s)
            state["q_end"] = max(state.get("q_end", e), e)
            state.setdefault("q_seq", []).append(tok[3])
        elif line.startswith("T "):
            tok = line.split()
            if tok[1] in _SKIP_TAGS:
                continue
            s = _int_field(tok[2], "start index of template alignment")
            e = _int_field(tok[4], "end index of template alignment")
            state["t_start"] = min(state.get("t_start", s), s)
            state["t_end"] = max(state.get("t_end", e), e)
            state.setdefault("t_seq", []).append(tok[3])
            state["t_len"] = _int_field(
                tok[5].strip("()") if len(tok) > 5 else tok[4],
                "template length in template alignment")
    flush()
    return results


def read_result(input_file: str) -> List[hhr_alignment]:
    with open(input_file) as f:
        return parse_result(f.read().splitlines())
