"""ffindex flat-file database: byte-identical reader/writer.

Format (lib/ffindex/src/ffindex.h:11-41): ``.ffdata`` is the concatenation
of entries, each terminated by NUL; ``.ffindex`` is text lines
``name\\toffset\\tlength`` (length includes the NUL), sorted by name for
binary-search lookup.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class FFindexEntry:
    name: str
    offset: int
    length: int          # includes trailing NUL


class FFindexDatabase:
    """Memory-mapped read access to an ffindex database."""

    def __init__(self, data_path: str, index_path: str):
        self.data_path = data_path
        self.index_path = index_path
        self.entries: List[FFindexEntry] = []
        self.by_name: Dict[str, FFindexEntry] = {}
        from ..native import load as _load_native

        nat = _load_native()
        if nat is not None:
            with open(index_path, "rb") as f:
                rows = nat.parse_index(f.read())
            for name, off, length in rows:
                e = FFindexEntry(name, off, length)
                self.entries.append(e)
                self.by_name[e.name] = e
        else:
            with open(index_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    parts = line.rstrip("\n").split("\t")
                    e = FFindexEntry(parts[0], int(parts[1]),
                                     int(parts[2]))
                    self.entries.append(e)
                    self.by_name[e.name] = e
        self.data = np.memmap(data_path, dtype=np.uint8, mode="r") \
            if os.path.getsize(data_path) else np.zeros(0, np.uint8)

    def __len__(self):
        return len(self.entries)

    def __contains__(self, name: str):
        return name in self.by_name

    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    def index_of(self, name: str) -> int:
        """Position of ``name`` in index order, -1 if absent (pointer
        arithmetic entry - entry_zero in a3m_compress.cpp:372-373)."""
        e = self.by_name.get(name)
        if e is None:
            return -1
        if not hasattr(self, "_index_pos"):
            self._index_pos = {id(en): k
                               for k, en in enumerate(self.entries)}
        return self._index_pos[id(e)]

    def read_bytes(self, name_or_entry) -> bytes:
        e = (name_or_entry if isinstance(name_or_entry, FFindexEntry)
             else self.by_name[name_or_entry])
        raw = bytes(self.data[e.offset: e.offset + e.length])
        return raw[:-1] if raw.endswith(b"\x00") else raw

    def read_text(self, name_or_entry) -> str:
        return self.read_bytes(name_or_entry).decode("utf-8",
                                                     errors="replace")

    def items(self) -> Iterator[Tuple[str, bytes]]:
        for e in self.entries:
            yield e.name, self.read_bytes(e)


class FFindexWriter:
    """Streaming writer producing a sorted index like ffindex_build -s."""

    def __init__(self, data_path: str, index_path: str):
        self.data_path = data_path
        self.index_path = index_path
        self._data = open(data_path, "wb")
        self._entries: List[FFindexEntry] = []
        self._offset = 0

    def add(self, name: str, payload: bytes):
        if isinstance(payload, str):
            payload = payload.encode()
        self._data.write(payload)
        self._data.write(b"\x00")
        self._entries.append(FFindexEntry(name, self._offset,
                                          len(payload) + 1))
        self._offset += len(payload) + 1

    def close(self, sort: bool = True):
        self._data.close()
        entries = sorted(self._entries, key=lambda e: e.name) if sort \
            else self._entries
        with open(self.index_path, "w") as f:
            for e in entries:
                f.write(f"{e.name}\t{e.offset}\t{e.length}\n")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def build_ffindex(data_path: str, index_path: str,
                  items: List[Tuple[str, bytes]], sort: bool = True):
    w = FFindexWriter(data_path, index_path)
    for name, payload in items:
        w.add(name, payload)
    w.close(sort=sort)
