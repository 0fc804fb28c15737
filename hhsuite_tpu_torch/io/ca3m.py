"""Compressed A3M (ca3m) databases.

Byte-level parity with the reference's compressed-a3m codec
(src/a3m_compress.cpp): a ca3m entry is

    [optional '#'-comment line]
    consensus header line '\\n' consensus sequence '\\n' ';'
    then per member sequence:
      u32 LE  entry index into the shared _sequence/_header ffindex DBs
      u16 LE  1-based start position of the alignment in the full sequence
      u16 LE  number of blocks
      blocks: i8 nr_matches, then i8 x (x>0: x insertions, x<=0: -x gaps)

Consumers: extract_a3m (src/a3m_compress.cpp:245-354) reconstructs plain
a3m text; Alignment::ReadCompressed (src/hhalignment.cpp:546-812) builds
the MSA directly with the consensus as displayed-but-not-kept first
sequence.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .ffindex import FFindexDatabase

SCHAR_MAX = 127


def get_name_from_header(header: str) -> str:
    """a3m_compress.cpp:508-519: id = header[1:first whitespace)."""
    for index, ch in enumerate(header):
        if ch.isspace():
            return header[1:index]
    return header[1:]


def get_short_id_from_header(hid: str) -> str:
    """a3m_compress.cpp:521-542: between first and second '|' if both
    exist."""
    first = second = len(hid)
    for index, ch in enumerate(hid):
        if ch == "|":
            if first == len(hid):
                first = index
            elif second == len(hid):
                second = index
    if first != len(hid) and second != len(hid):
        return hid[first + 1:second]
    return hid


def is_consensus(hid: str) -> bool:
    """a3m_compress.cpp:544-546."""
    return len(hid) > 11 and hid[-10:] == "_consensus"


def get_start_pos(aligned: str, full: bytes) -> int:
    """1-based start of the ungapped aligned sequence within the full
    sequence (a3m_compress.cpp:477-498); 0 = not found."""
    res = aligned.replace("-", "").upper().encode()
    if not res:
        return 0
    return full.find(res) + 1


def compress_sequence(seq_id: str, aligned: str,
                      seq_db: FFindexDatabase) -> Optional[bytes]:
    """One member sequence -> binary record (a3m_compress.cpp:356-474)."""
    entry_index = seq_db.index_of(seq_id)
    if entry_index < 0:
        return None
    full = seq_db.read_bytes(seq_db.entries[entry_index])
    start_pos = get_start_pos(aligned, full)
    if start_pos == 0:
        return None

    out = bytearray()
    out += struct.pack("<I", entry_index)
    out += struct.pack("<H", start_pos)

    # run-length blocks, each count clamped to SCHAR_MAX
    blocks = bytearray()
    nr_blocks = 0
    index = 0
    n = len(aligned)
    while index < n:
        nr_matches = 0
        while index < n and aligned[index] != "-" and aligned[index].isupper():
            nr_matches += 1
            index += 1
        nr_insertions = 0
        while index < n and aligned[index].islower():
            nr_insertions += 1
            index += 1
        nr_gaps = 0
        while nr_insertions == 0 and index < n and aligned[index] == "-":
            nr_gaps += 1
            index += 1
        while nr_gaps != 0 or nr_insertions != 0 or nr_matches != 0:
            if index == n and nr_matches == 0 and nr_insertions == 0:
                break
            pm = min(nr_matches, SCHAR_MAX)
            pg = min(nr_gaps, SCHAR_MAX)
            pi = min(nr_insertions, SCHAR_MAX)
            nr_matches -= pm
            nr_gaps -= pg
            nr_insertions -= pi
            blocks.append(pm)
            blocks.append(pi if pi > 0 else (-pg) & 0xFF)
            nr_blocks += 1

    out += struct.pack("<H", nr_blocks)
    out += bytes(blocks)
    return bytes(out)


def compress_a3m(text: str, seq_db: FFindexDatabase) -> Optional[bytes]:
    """a3m text -> ca3m entry body (a3m_compress.cpp:118-242).

    Returns None when no sequence could be matched against the sequence
    database (the reference prints a warning and reports failure).
    """
    out = bytearray()
    nr_sequences = 0
    nr_consensus = 0

    lines = text.split("\n")
    li = 0
    # leading '#' comment is preserved; later comments dropped
    if lines and lines[0].startswith("#"):
        out += lines[0].encode() + b"\n"
        li = 1

    header = None
    hid = None
    consensus_flag = False
    seq_parts: List[str] = []

    def flush():
        nonlocal nr_sequences, nr_consensus
        if hid is None:
            return
        sequence = "".join(seq_parts)
        if consensus_flag:
            out.extend(header.encode() + b"\n")
            out.extend(sequence.encode() + b"\n")
            out.append(ord(";"))
            nr_consensus += 1
        else:
            rec = compress_sequence(get_short_id_from_header(hid), sequence,
                                    seq_db)
            if rec is not None:
                out.extend(rec)
                nr_sequences += 1

    while li < len(lines):
        line = lines[li]
        if line.startswith("#"):
            pass
        elif line.startswith(">ss_pred") or line.startswith(">ss_conf"):
            li += 1
            while li < len(lines) and not lines[li].startswith(">"):
                li += 1
            continue
        elif line.startswith(">"):
            flush()
            seq_parts = []
            header = line
            hid = get_name_from_header(header)
            consensus_flag = is_consensus(hid)
        elif header is not None:
            seq_parts.append(line)
        li += 1
    flush()

    if nr_consensus > 1 or nr_sequences == 0:
        return None
    return bytes(out)


def _split_preamble(data: bytes) -> Tuple[str, str, str, int]:
    """Return (comment_line_or_empty, consensus_header, consensus_seq,
    offset of first binary record)."""
    pos = 0
    comment = ""
    if data[:1] == b"#":
        nl = data.index(b"\n", pos)
        comment = data[pos:nl].decode("utf-8", "replace")
        pos = nl + 1
    # scan until '\n' followed by ';'
    in_consensus = 0
    header_end = seq_end = None
    last = b""
    start = pos
    while pos < len(data):
        c = data[pos:pos + 1]
        if last == b"\n" and c == b";":
            break
        if c == b"\n":
            if in_consensus == 0:
                header_end = pos
            elif in_consensus == 1 and seq_end is None:
                seq_end = pos
            in_consensus += 1
        last = c
        pos += 1
    header = data[start:header_end].decode("utf-8", "replace")
    cons = data[header_end + 1: seq_end].decode("utf-8", "replace")
    return comment, header, cons, pos + 1


def _iter_records(data: bytes, offset: int):
    """Yield (entry_index, start_pos, [(nr_matches, ins_del), ...])."""
    from ..native import load as _load_native

    nat = _load_native()
    if nat is not None:
        for entry_index, start_pos, blocks in nat.iter_ca3m_records(
                data, offset):
            yield entry_index, start_pos, blocks
        return
    pos = offset
    end = len(data)             # NUL already stripped by read_bytes
    while pos + 8 <= end:
        entry_index, start_pos, nr_blocks = struct.unpack_from(
            "<IHH", data, pos)
        pos += 8
        blocks = []
        for _b in range(nr_blocks):
            nr_matches = data[pos]
            ins_del = struct.unpack_from("<b", data, pos + 1)[0]
            pos += 2
            blocks.append((nr_matches, ins_del))
        yield entry_index, start_pos, blocks


def _expand_record(start_pos: int, blocks, full_seq: bytes,
                   consensus_length: int) -> str:
    from ..native import load as _load_native

    nat = _load_native()
    if nat is not None:
        if not isinstance(blocks, (bytes, bytearray)):
            blocks = b"".join(
                bytes([m]) + ib.to_bytes(1, "little", signed=True)
                for m, ib in blocks)
        return nat.expand_ca3m_record(
            start_pos, bytes(blocks), full_seq,
            consensus_length).decode("latin-1")
    chars: List[str] = []
    actual = start_pos
    aln_len = 0
    if isinstance(blocks, (bytes, bytearray)):
        blocks = [(blocks[k],
                   int.from_bytes(blocks[k + 1:k + 2], "little",
                                  signed=True))
                  for k in range(0, len(blocks) - 1, 2)]
    for nr_matches, ins_del in blocks:
        for _i in range(nr_matches):
            chars.append(chr(full_seq[actual - 1]))
            actual += 1
            aln_len += 1
        if ins_del > 0:
            for _i in range(ins_del):
                chars.append(chr(full_seq[actual - 1]).lower())
                actual += 1
        else:
            for _i in range(-ins_del):
                chars.append("-")
                aln_len += 1
    while aln_len < consensus_length:
        chars.append("-")
        aln_len += 1
    return "".join(chars)


def extract_a3m(data: bytes, seq_db: FFindexDatabase,
                header_db: FFindexDatabase) -> str:
    """ca3m entry -> a3m text, byte-exact vs the reference extractor
    (a3m_compress.cpp:245-354) — including its quirk of writing the
    stored header's trailing newline AND a separating newline, which
    yields a blank line after every member header."""
    comment, header, cons, offset = _split_preamble(data)
    parts: List[str] = []
    if comment:
        parts.append(comment + "\n")
    parts.append(header + "\n")
    parts.append(cons + "\n")
    consensus_length = len(cons)
    for entry_index, start_pos, blocks in _iter_records(data, offset):
        seq_entry = seq_db.entries[entry_index]
        full = seq_db.read_bytes(seq_entry).rstrip(b"\n\x00")
        hdr_entry = header_db.entries[entry_index]
        hdr = header_db.read_bytes(hdr_entry).decode("utf-8", "replace")
        if not hdr.startswith(">"):
            parts.append(">")
        parts.append(hdr)
        parts.append("\n")
        parts.append(_expand_record(start_pos, blocks, full,
                                    consensus_length))
        parts.append("\n")
    return "".join(parts)


def read_compressed(entry_name: str, data: bytes,
                    seq_db: FFindexDatabase, header_db: FFindexDatabase,
                    mark: int = 0, maxseq: int = 65535):
    """ca3m entry -> Alignment (Alignment::ReadCompressed,
    src/hhalignment.cpp:546-812): the consensus becomes sequence 0 with
    display=2, keep=0 and kfirst=0."""
    import os

    from ..core.alignment import AA2I_TABLE, Alignment

    ali = Alignment()
    base = os.path.basename(entry_name)
    ali.file = base.rsplit(".", 1)[0] if "." in base else base

    comment, header, cons, offset = _split_preamble(data)
    if comment:
        body = comment[1:].lstrip()
        ali.longname = body[:32764]
        ali.name = (body.split() or [""])[0][:511]
        ali.readCommentLine = "1"

    def clean(s: str) -> str:
        return "".join(c for c in s if AA2I_TABLE[ord(c) & 0xFF] >= 0)

    names: List[str] = []
    seqs: List[str] = []
    keep: List[int] = []
    display: List[int] = []

    names.append(header[1:].strip())
    seqs.append("-" + clean(cons))
    display.append(2)
    keep.append(0)
    ali.kfirst = 0
    ali.n_display = 1
    consensus_length = len(cons)

    for entry_index, start_pos, blocks in _iter_records(data, offset):
        full = seq_db.read_bytes(seq_db.entries[entry_index]).rstrip(
            b"\n\x00")
        hdr = header_db.read_bytes(header_db.entries[entry_index]).rstrip(
            b"\x00").rstrip(b"\n").decode("utf-8", "replace")
        names.append(hdr.lstrip(">").strip())
        seqs.append("-" + clean(_expand_record(start_pos, blocks, full,
                                               consensus_length)))
        if mark in (0, 1):
            display.append(1)
            keep.append(1)
            ali.n_display += 1
        else:
            display.append(0)
            keep.append(1)

    ali.names = names
    ali.seqs = seqs
    ali.keep = np.array(keep, dtype=np.int8)
    ali.display = np.array(display, dtype=np.int8)
    ali.N_in = len(names)
    ali.N_filtered = 0
    if not ali.longname:
        ali.longname = names[0][:32764]
        ali.name = (names[0].split() or [""])[0][:511]
    return ali
