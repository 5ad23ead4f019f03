"""Paged table format (the port of ``repro.storage.paged``): the
Parquet-shaped baseline of §2.2.

One file per table with the hierarchical metadata that makes Parquet slow
to read at device speed: a file footer, per-row-group metadata, and
per-page headers that the read parses and interprets in turn, with data
and decode interleaved. Integer pages are delta-encoded, so the read has
real decode work, as Parquet's encodings do; it stays on the host, as in
the reference. The writer's bytes are the reference writer's.

This format exists to measure the gap the paper quantifies (their Parquet
read ran 10x below the hardware I/O bound; their minimal format hit 95%).
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core import dtypes as dt
from ..core.session import TableSource
from ..core.streaming import HostMorsel, ScanStats, empty_morsel, stacked_morsel
from .zonemap import may_match

_MAGIC = b"PGD1"
_PAGE_ROWS = 1024


def write_paged_table(root: str, name: str, data: Dict[str, np.ndarray],
                      schema: Dict[str, dt.DType], row_groups: int = 4) -> None:
    """Persist a table in the paged format: magic, delta-encoded pages with
    JSON headers, per-row-group metadata, JSON footer + trailing offset."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{name}.paged")
    n = len(next(iter(data.values())))
    per_rg = max(1, (n + row_groups - 1) // row_groups)
    rg_meta = []
    with open(path, "wb") as f:
        f.write(_MAGIC)
        for rg in range(row_groups):
            lo, hi = rg * per_rg, min((rg + 1) * per_rg, n)
            col_meta = {}
            for col, d in schema.items():
                arr = np.asarray(data[col][lo:hi], dtype=d.np_dtype())
                pages = []
                for p0 in range(0, max(hi - lo, 1), _PAGE_ROWS):
                    page = arr[p0: p0 + _PAGE_ROWS]
                    if d.name in ("bytes", "float32", "float64", "bool"):
                        payload = page.tobytes()
                        enc = "plain"
                    else:
                        # delta encoding: first value + int32 deltas
                        flat = page.astype(np.int64)
                        first = int(flat[0]) if len(flat) else 0
                        deltas = np.diff(flat, prepend=first).astype(np.int32)
                        payload = deltas.tobytes()
                        enc = "delta"
                    stat = len(page) and d.name != "bytes"
                    header = json.dumps({
                        "rows": int(len(page)), "enc": enc, "col": col,
                        "dtype": d.name, "width": d.width,
                        "first": int(page[0]) if (enc == "delta" and len(page)) else 0,
                        "min": float(page.min()) if stat else 0,
                        "max": float(page.max()) if stat else 0,
                    }).encode()
                    off = f.tell()
                    f.write(struct.pack("<I", len(header)))
                    f.write(header)
                    f.write(struct.pack("<I", len(payload)))
                    f.write(payload)
                    pages.append(off)
                col_meta[col] = pages
            rg_meta.append({"rows": hi - lo, "columns": col_meta})
        footer = json.dumps({
            "rows": n,
            "row_groups": rg_meta,
            "schema": {c: {"name": d.name, "width": d.width,
                           "dict": list(d.dictionary) if d.dictionary else None}
                       for c, d in schema.items()},
        }).encode()
        foff = f.tell()
        f.write(footer)
        f.write(struct.pack("<Q", foff))


class PagedTable:
    """Reader that walks footer -> row group -> page headers, parsing and
    decoding as it goes (the interpretation overhead under study)."""

    def __init__(self, root: str, name: str):
        self.path = os.path.join(root, f"{name}.paged")
        with open(self.path, "rb") as f:
            f.seek(-8, os.SEEK_END)
            (foff,) = struct.unpack("<Q", f.read(8))
            end = f.tell() - 8
            f.seek(foff)
            self.footer = json.loads(f.read(end - foff))
        sch = {}
        for c, meta in self.footer["schema"].items():
            if meta["name"] == "bytes":
                sch[c] = dt.bytes_(meta["width"])
            elif meta["name"] == "dict32":
                sch[c] = dt.DType("dict32", dictionary=tuple(meta["dict"]))
            else:
                sch[c] = dt.DType(meta["name"])
        self.schema = sch
        self.pages_read = 0
        self.bytes_read = 0

    def _read_page(self, f, off: int, d: dt.DType) -> np.ndarray:
        f.seek(off)
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))          # metadata interpret
        (plen,) = struct.unpack("<I", f.read(4))
        payload = f.read(plen)
        self.pages_read += 1
        self.bytes_read += plen
        rows = header["rows"]
        if header["enc"] == "delta":               # decode interleaved
            deltas = np.frombuffer(payload, dtype=np.int32).astype(np.int64)
            vals = header["first"] + np.cumsum(deltas)
            return vals.astype(d.np_dtype())
        if d.name == "bytes":
            return np.frombuffer(payload, dtype=np.uint8).reshape(rows, d.width)
        return np.frombuffer(payload, dtype=d.np_dtype())

    def _read_page_header(self, f, off: int) -> dict:
        """Header only (min/max zone map), payload left unread."""
        f.seek(off)
        (hlen,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(hlen))

    def _decode(self, offsets, col: str) -> np.ndarray:
        d = self.schema[col]
        with open(self.path, "rb") as f:
            out = [self._read_page(f, off, d) for off in offsets]
        return np.concatenate(out) if out else np.zeros(0, d.np_dtype())

    def read_rowgroup_column(self, rg_index: int, col: str) -> np.ndarray:
        """Decode every page of one column within one row group."""
        return self._decode(
            self.footer["row_groups"][rg_index]["columns"][col], col)

    def read_column(self, col: str) -> np.ndarray:
        """Decode one column across all row groups (full-table read)."""
        return self._decode([off for rg in self.footer["row_groups"]
                             for off in rg["columns"][col]], col)

    def rowgroup_range(self, rg_index: int,
                       col: str) -> Optional[Tuple[float, float]]:
        """Row-group min/max for ``col`` from its page headers (the paged
        format's zone map), or None for stat-less (bytes) columns."""
        if self.schema[col].name == "bytes":
            return None
        lo, hi = math.inf, -math.inf
        with open(self.path, "rb") as f:
            for off in self.footer["row_groups"][rg_index]["columns"][col]:
                h = self._read_page_header(f, off)
                if h["rows"]:
                    lo, hi = min(lo, h["min"]), max(hi, h["max"])
        if lo > hi:
            return None
        return (lo, hi)


class PagedTableSource(TableSource):
    """TableSource over the paged format: one row group per worker per
    step, page-header min/max acting as the zone map for data skipping.

    The same prefetch pipeline runs over either format, so the extra
    metadata interpretation and decode of this one shows up in
    ``ScanStats.read_seconds``.
    """

    def __init__(self, root: str, name: str, skip_with_stats: bool = True):
        self.reader = PagedTable(root, name)
        self.name = name
        self.schema = self.reader.schema
        self.skip_with_stats = skip_with_stats
        self.chunks_skipped = 0
        self._range_cache: Dict[Tuple[int, str], object] = {}

    def num_rows(self) -> int:
        return int(self.footer["rows"])

    @property
    def footer(self) -> dict:
        """The file footer (row counts, row-group + schema metadata)."""
        return self.reader.footer

    @property
    def num_chunks(self) -> int:
        return len(self.footer["row_groups"])

    def _get_range(self, rg: int, col: str):
        key = (rg, col)
        if key not in self._range_cache:
            self._range_cache[key] = self.reader.rowgroup_range(rg, col)
        return self._range_cache[key]

    def _rg_survives(self, rg: int, filter_expr) -> bool:
        if not (self.skip_with_stats and filter_expr is not None):
            return True
        return may_match(filter_expr, lambda col: self._get_range(rg, col))

    def _host_morsels(self, columns, batch_rows: int,
                      stats: Optional[ScanStats] = None,
                      num_workers: int = 1, filter_expr=None,
                      pin: bool = False) -> Iterator[List[HostMorsel]]:
        cols = list(columns) if columns else list(self.schema.keys())
        w = num_workers
        schema = {c: self.schema[c] for c in cols}
        groups = self.footer["row_groups"]
        live = [g for g in range(len(groups))
                if self._rg_survives(g, filter_expr)]
        skipped = len(groups) - len(live)
        self.chunks_skipped += skipped
        if stats is not None:
            stats.chunks_total += len(groups)
            stats.chunks_skipped += skipped
        if not live:
            yield empty_morsel(schema, w)
            return

        def read(c, g, out):
            before = self.reader.bytes_read
            arr = self.reader.read_rowgroup_column(g, c)
            if stats is not None:
                stats.bytes_read += self.reader.bytes_read - before
            out[:len(arr)] = arr
            return len(arr)

        for r in range(math.ceil(len(live) / w)):
            assigned = live[r * w: (r + 1) * w]
            cap = max(int(groups[g]["rows"]) for g in assigned)
            yield stacked_morsel(cols, self.schema, w, assigned, cap, read,
                                 pin=pin)
