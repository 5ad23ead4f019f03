"""Column-chunk storage format (the port of ``repro.storage.colchunk``;
the paper's §2.2 minimal format).

Layout on disk, for table ``t`` with C columns split into K chunks:

    <root>/t/<column>.<chunk>.<rows>.<dtypecode>.bin     (C x K files)
    <root>/t/<column>.dict                               (dict32 columns)
    <root>/t/_stats.json                                 (optional min/max)

The file name carries the minimal metadata (column name, type, size); the
payload is the raw little-endian buffer, so a read interprets nothing. A
chunk is the unit of I/O, and the partition count (chunks) is the
experiment knob of the paper's Table 1. The writer's bytes, names and
sidecars are the reference writer's.

The optional _stats.json (per-chunk min/max) powers zone-map data
skipping: a chunk is skipped only when its stats refute the pushed-down
predicate, so results are identical with skipping on or off.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..core import dtypes as dt
from ..core.expr import Expr
from ..core.session import TableSource
from ..core.streaming import HostMorsel, ScanStats, empty_morsel, stacked_morsel
from .zonemap import may_match

_CODE = {"int32": "i4", "int64": "i8", "float32": "f4", "float64": "f8",
         "bool": "b1", "date32": "d4", "dict32": "c4"}
_RCODE = {v: k for k, v in _CODE.items()}
# logical types whose chunks get min/max stats
_STAT_TYPES = ("int32", "int64", "date32", "dict32", "float32", "float64")


def _dtype_code(d: dt.DType) -> str:
    if d.name == "bytes":
        return f"s{d.width}"
    return _CODE[d.name]


def _decode_dtype(code: str, dictionary=None) -> dt.DType:
    if code.startswith("s"):
        return dt.bytes_(int(code[1:]))
    name = _RCODE[code]
    if name == "dict32":
        return dt.DType("dict32", dictionary=tuple(dictionary or ()))
    return dt.DType(name)


def write_table(root: str, name: str, data: Dict[str, np.ndarray],
                schema: Dict[str, dt.DType], chunks: int = 1,
                stats: bool = True) -> None:
    """Persist a table as one binary file per (column, chunk), with the
    metadata in the file name (the paper's minimal column-chunk format)."""
    tdir = os.path.join(root, name)
    os.makedirs(tdir, exist_ok=True)
    n = len(next(iter(data.values())))
    per = math.ceil(n / chunks)
    stat_entries: Dict[str, List] = {}
    for col, d in schema.items():
        arr = np.ascontiguousarray(np.asarray(data[col], dtype=d.np_dtype()))
        if d.name == "dict32":
            with open(os.path.join(tdir, f"{col}.dict"), "w") as f:
                json.dump(list(d.dictionary), f)
        col_stats = []
        for k in range(chunks):
            part = arr[k * per: min((k + 1) * per, n)]
            fname = f"{col}.{k}.{len(part)}.{_dtype_code(d)}.bin"
            part.tofile(os.path.join(tdir, fname))
            if stats and d.name in _STAT_TYPES and len(part):
                col_stats.append([float(part.min()), float(part.max())])
            else:
                col_stats.append(None)
        stat_entries[col] = col_stats
    if stats:
        with open(os.path.join(tdir, "_stats.json"), "w") as f:
            json.dump({"rows": n, "chunks": chunks, "stats": stat_entries}, f)


def read_column_chunk(root: str, table: str, column: str, chunk: int,
                      fname: Optional[str] = None) -> np.ndarray:
    """One chunk of one column as a read-only memmap of its file (the scan
    maps nothing: it reads each file straight into a morsel's buffer).

    ``fname`` skips the directory scan when the caller already indexed the
    chunk files (``ColumnChunkTable`` does; a listdir per read is O(C x K)).
    """
    tdir = os.path.join(root, table)
    if fname is None:
        prefix = f"{column}.{chunk}."
        fname = next(f for f in os.listdir(tdir) if f.startswith(prefix)
                     and f.endswith(".bin"))
    _, _, rows, code, _ = fname.split(".")
    rows = int(rows)
    path = os.path.join(tdir, fname)
    if code.startswith("s"):
        width = int(code[1:])
        if not rows:      # numpy cannot map an empty file
            return np.zeros((0, width), dtype=np.uint8)
        return np.memmap(path, dtype=np.uint8, mode="r").reshape(rows, width)
    d = _decode_dtype(code)
    if not rows:
        return np.zeros(0, dtype=d.np_dtype())
    return np.memmap(path, dtype=d.np_dtype(), mode="r")


def _read_chunk_into(path: str, out: np.ndarray) -> int:
    """Read one chunk file into the front of ``out`` (a C-contiguous
    buffer of at least its rows) with one ``readinto``: no mapping and no
    copy on the way. Returns the bytes read."""
    with open(path, "rb", buffering=0) as f:
        view = memoryview(out.reshape(-1).view(np.uint8))
        nbytes = 0
        while True:                  # readinto may return short
            got = f.readinto(view[nbytes:])
            if not got:
                return nbytes
            nbytes += got


class ColumnChunkTable(TableSource):
    """TableSource over the column-chunk format.

    Chunks go to the workers round-robin (the paper's per-process data
    fraction); each scan step is one chunk per worker, so ``batch_rows`` is
    ignored. ``skip_with_stats`` turns on min/max (zone-map) chunk skipping
    against the pushed-down scan predicate: a skipped chunk is never read
    and never copied to the device. ``bytes_read`` and ``chunks_skipped``
    count over the source's life, as in the reference.
    """

    def __init__(self, root: str, name: str, skip_with_stats: bool = True):
        self.root = root
        self.name = name
        self.skip_with_stats = skip_with_stats
        tdir = os.path.join(root, name)
        self.schema: Dict[str, dt.DType] = {}
        self._chunks = 0
        dicts = {}
        listing = sorted(os.listdir(tdir))
        for f in listing:
            if f.endswith(".dict"):
                with open(os.path.join(tdir, f)) as fh:
                    dicts[f[:-5]] = json.load(fh)
        self._files: Dict[tuple, str] = {}       # (column, chunk) -> filename
        for f in listing:
            if not f.endswith(".bin"):
                continue
            col, chunk, _, code, _ = f.split(".")
            self.schema.setdefault(col, _decode_dtype(code, dicts.get(col)))
            self._chunks = max(self._chunks, int(chunk) + 1)
            self._files[(col, int(chunk))] = f
        first = next(iter(self.schema))
        self._chunk_rows = [int(self._files[(first, k)].split(".")[2])
                            for k in range(self._chunks)]
        self._stats = None
        spath = os.path.join(tdir, "_stats.json")
        if os.path.exists(spath):
            with open(spath) as fh:
                self._stats = json.load(fh)
        self.bytes_read = 0
        self.chunks_skipped = 0

    def num_rows(self) -> int:
        return sum(self._chunk_rows)

    @property
    def num_chunks(self) -> int:
        return self._chunks

    # -- data skipping (driven by the pushed-down filter) -------------------
    def _chunk_survives(self, chunk: int, filter_expr: Optional[Expr]) -> bool:
        if not (self.skip_with_stats and self._stats and filter_expr is not None):
            return True

        def get_range(col: str):
            entry = self._stats["stats"].get(col)
            if not entry or entry[chunk] is None:
                return None
            return tuple(entry[chunk])

        return may_match(filter_expr, get_range)

    def _host_morsels(self, columns, batch_rows: int,
                      stats: Optional[ScanStats] = None,
                      num_workers: int = 1, filter_expr=None,
                      pin: bool = False) -> Iterator[List[HostMorsel]]:
        cols = list(columns) if columns else list(self.schema.keys())
        w = num_workers
        schema = {c: self.schema[c] for c in cols}
        live = [k for k in range(self._chunks)
                if self._chunk_survives(k, filter_expr)]
        skipped = self._chunks - len(live)
        self.chunks_skipped += skipped
        if stats is not None:
            stats.chunks_total += self._chunks
            stats.chunks_skipped += skipped
        if not live:
            # every chunk pruned: one all-dead step keeps the operators
            # downstream fed (each needs at least one batch)
            yield empty_morsel(schema, w)
            return

        tdir = os.path.join(self.root, self.name)

        def read(c, k, out):
            fname = self._files[(c, k)]
            rows = int(fname.split(".")[2])
            nbytes = _read_chunk_into(os.path.join(tdir, fname), out)
            if nbytes != rows * out.strides[0]:
                raise IOError(f"{fname}: {nbytes} bytes, its name says "
                              f"{rows} rows of {out.strides[0]} bytes")
            self.bytes_read += nbytes
            if stats is not None:
                stats.bytes_read += nbytes
            return rows

        for r in range(math.ceil(len(live) / w)):
            assigned = live[r * w: (r + 1) * w]
            cap = max(self._chunk_rows[k] for k in assigned)
            yield stacked_morsel(cols, self.schema, w, assigned, cap, read,
                                 pin=pin)
