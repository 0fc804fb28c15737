"""A3M container with format validation.

Equivalent of scripts/a3m.py (A3M_Container/A3MFormatError): validates
match-state consistency across sequences, consensus and annotation rows,
extracts column-range sub-alignments, and backs the check_a3m /
get_a3m_size command-line tools (scripts/check_a3m.py,
scripts/get_a3m_size.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

RESIDUES = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
MATCH_STATES = frozenset(RESIDUES)
INSERT_STATES = frozenset(RESIDUES.lower())
GAP_STATES = frozenset("-.")
SS_CONF_STATES = frozenset("0123456789")
SS_STATES = frozenset("ECH")
DSSP_STATES = frozenset("CHBEGITS-")


class A3MFormatError(Exception):
    """scripts/a3m.py:4-9."""

    def __init__(self, value):
        self.value = "ERROR: " + str(value)

    def __str__(self):
        return repr(self.value)


class A3MContainer:
    """Validating a3m reader (scripts/a3m.py:12-257).

    Sequences count match states as upper-case residues plus gap
    characters ('-' AND '.', a reference quirk); every row must agree
    on that count.
    """

    def __init__(self):
        self.header: Optional[str] = None
        self.annotations: Dict[str, str] = {}
        self.consensus: Optional[Tuple[str, str]] = None
        self.sequences: List[Tuple[str, str]] = []
        self.nr_match_states: Optional[int] = None

    @property
    def number_sequences(self) -> int:
        return len(self.sequences)

    get_number_sequences = lambda self: self.number_sequences  # noqa: E731

    # -- validation ----------------------------------------------------
    def _check_match_states(self, count: int):
        if self.nr_match_states is None:
            self.nr_match_states = count
        if count == 0:
            raise A3MFormatError("Sequence with zero match states!")
        if count != self.nr_match_states:
            raise A3MFormatError(
                f"Sequence with diverging number of match states "
                f"({count} vs. {self.nr_match_states})!")

    def _check_states(self, seq: str, valid: frozenset, counted: frozenset,
                      what: str):
        self._check_match_states(
            sum(1 for c in seq if c in counted))
        bad = set(seq) - valid
        if bad:
            raise A3MFormatError(
                f"Undefined character(s) '{bad}' in {what}!")

    def check_sequence(self, seq: str):
        self._check_states(seq, MATCH_STATES | GAP_STATES | INSERT_STATES,
                           MATCH_STATES | GAP_STATES, "protein sequence")

    # -- record dispatch -----------------------------------------------
    def add_record(self, header: str, seq: str):
        name = header[1:].split()[0] if header[1:].split() else ""
        if header[1:].startswith("ss_conf"):
            self._unique_annotation("ss_conf")
            self._check_states(seq, SS_CONF_STATES | GAP_STATES,
                               SS_CONF_STATES | GAP_STATES,
                               "predicted secondary structure confidence")
            self.annotations["ss_conf"] = seq
        elif header[1:].startswith("ss_pred"):
            self._unique_annotation("ss_pred")
            self._check_states(seq, SS_STATES | GAP_STATES,
                               SS_STATES | GAP_STATES,
                               "predicted secondary structure")
            self.annotations["ss_pred"] = seq
        elif header[1:].startswith("ss_dssp"):
            self._unique_annotation("ss_dssp")
            self._check_states(seq, DSSP_STATES, DSSP_STATES,
                               "dssp annotation")
            self.annotations["ss_dssp"] = seq
        elif name.endswith("_consensus"):
            if self.consensus is not None:
                raise A3MFormatError("Multiple definitions of consensus!")
            self.check_sequence(seq)
            self.consensus = (header, seq)
        else:
            self.check_sequence(seq)
            self.sequences.append((header, seq))

    def _unique_annotation(self, key: str):
        if key in self.annotations:
            raise A3MFormatError(f"Multiple definitions of {key}!")

    # -- io --------------------------------------------------------------
    def read_a3m(self, fh):
        self.read_a3m_from_lines(fh.readlines())

    def read_a3m_from_lines(self, lines):
        header = None
        parts: List[str] = []
        first = True
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if line[0] == "#":
                if first:
                    self.header = line
            elif line[0] == ">":
                if header is not None:
                    self.add_record(header, "".join(parts))
                    parts = []
                header = line
            else:
                parts.append(line.strip("\x00"))
            first = False
        if header is not None:
            self.add_record(header, "".join(parts))

    def __str__(self):
        out = []
        if self.header:
            out.append(self.header)
        if self.consensus:
            out += [self.consensus[0], self.consensus[1]]
        for h, s in self.sequences:
            out += [h, s]
        return "\n".join(out)

    # -- column-range extraction (scripts/a3m.py:152-208) ---------------
    def _sub_sequence(self, seq: str, limits) -> str:
        cols = MATCH_STATES | GAP_STATES
        out = []
        for start, end in limits:
            pos = 0
            start_i = end_i = 0
            for i, c in enumerate(seq):
                if c in cols:
                    pos += 1
                    if pos == start:
                        start_i = i
                    if pos == end:
                        end_i = i
                        break
            out.append(seq[start_i:end_i + 1])
        return "".join(out)

    def split_a3m(self, limits) -> "A3MContainer":
        new = A3MContainer()
        if self.consensus:
            new.consensus = (self.consensus[0],
                             self._sub_sequence(self.consensus[1], limits))
        for h, s in self.sequences:
            new.sequences.append((h, self._sub_sequence(s, limits)))
        return new


# reference-compatible aliases
A3M_Container = A3MContainer
