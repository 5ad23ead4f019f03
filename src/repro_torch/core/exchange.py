"""Inter-worker data exchange (the port of ``repro.core.exchange``).

A distributed stage holds one ``TorchTable`` per worker; an exchange takes
the list of the W source workers' tables and returns the list of the W
destination workers' tables. On one card every worker's tables live on the
same device (the reference's off-mesh path, "degenerate SPMD").

Two protocols, the paper's UcxExchange / HttpExchange contrast:

* ``ICIExchange``  -- device-native. A metadata phase hashes every row to
  its destination and counts the rows each source worker holds for each
  destination (``partition_histogram``, one launch of the
  ``radix_histogram`` kernel per repartition) and reads the
  ``[W_src, W_dst]`` matrix back in one sync to size the receive buffers;
  the data phase moves every column once, with one gather, straight into
  the compacted destination tables. Data never leaves device memory.
* ``HostExchange`` -- host-staged: device -> numpy, partitioned by a numpy
  hash, serialized into pickle pages, deserialized, and copied back to the
  device. It launches no kernel.

The on-mesh path (one worker per card, the all-to-all of
``_partition_layout_table`` + ``_exchange_data``) comes with the
multi-card slice (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import List, Sequence

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..kernels.radix_histogram import partition_histogram
from . import relational as rel
from .table import TorchTable

Tables = List[TorchTable]

_PAGE_ROWS = 4096   # rows per host-staged page, the reference's page size


@dataclasses.dataclass
class ExchangeStats:
    """Counters for one exchange protocol instance (rounds, rows/bytes
    moved, and -- for the host-staged baseline -- bytes through host)."""

    rounds: int = 0
    rows_moved: int = 0
    bytes_moved: int = 0            # payload bytes that crossed the exchange
    host_staged_bytes: int = 0      # bytes that round-tripped through host
    seconds: float = 0.0


def _row_bytes(table: TorchTable) -> int:
    per_row = 1  # validity byte
    for arr in table.columns.values():
        width = int(np.prod(arr.shape[1:])) if arr.dim() > 1 else 1
        per_row += arr.element_size() * width
    return per_row


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _gather_rows(tables: Tables, idx: torch.Tensor,
                 valid: torch.Tensor) -> TorchTable:
    """One table of the rows ``idx`` of every worker's rows laid end to end
    in worker order (one gather per column); ``valid`` marks its live
    rows."""
    idx = idx.long()
    cols = {n: torch.cat([t.columns[n] for t in tables]).index_select(0, idx)
            for n in tables[0].column_names}
    return TorchTable(cols, valid, dict(tables[0].schema))


def _compact_to(table: TorchTable, cap: int) -> TorchTable:
    """Move valid rows to the front (stable) and truncate to ``cap`` rows,
    gathering only the ``cap`` output rows: the j-th valid row is the first
    position whose running valid count reaches j + 1. Slots past the valid
    count hold the last row."""
    n = table.capacity
    csum = torch.cumsum(table.validity.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=table.device)
    gather = torch.searchsorted(csum, want, side="left")
    idx = torch.clamp(gather, max=n - 1)
    cols = {name: a.index_select(0, idx) for name, a in table.columns.items()}
    return TorchTable(cols, gather < n, table.schema)


def maybe_compact(tables: Sequence[TorchTable]) -> Tables:
    """Vector compaction when it at least halves capacity (§3.3.2): every
    worker's table is trimmed to pow2(the largest per-worker valid count),
    with one read-back of the counts. The driver calls it before a sort; at
    W=1 it is the reference's ``maybe_compact`` of one worker."""
    tables = list(tables)
    counts = torch.stack([t.num_valid() for t in tables]).tolist()
    cap = _pow2(max(max(counts), 1))
    if cap * 2 > tables[0].capacity:
        return tables
    return [_compact_to(t, cap) for t in tables]


class ExchangeProtocol:
    """Contract for moving per-worker tables between workers; the two
    implementations below mirror the paper's UcxExchange (device-native)
    vs HttpExchange (host-staged) contrast."""

    name = "exchange"

    def __init__(self):
        self.stats = ExchangeStats()

    def repartition(self, tables: Sequence[TorchTable],
                    key_names: Sequence[str], num_workers: int) -> Tables:
        """Hash-partition rows on ``key_names`` so equal keys land on the
        same worker (the shuffle between join/aggregation stages)."""
        raise NotImplementedError

    def broadcast(self, tables: Sequence[TorchTable],
                  num_workers: int) -> Tables:
        """Replicate every worker's valid rows to all workers."""
        raise NotImplementedError

    def clone(self) -> "ExchangeProtocol":
        """Fresh instance with the same configuration but zeroed stats."""
        return type(self)()

    @staticmethod
    def _ensure_rows(tables: Sequence[TorchTable]) -> Tables:
        """Pad a zero-capacity worker table to one dead row.

        A fragment can produce a 0-row table (all rows filtered, an empty
        partition after a skewed shuffle); the gathers and the operators
        downstream need at least one row slot."""
        return [t if t.capacity > 0 else t.pad_to(1) for t in tables]


class ICIExchange(ExchangeProtocol):
    """Device-native exchange (the paper's UcxExchange), off-mesh: every
    worker on one card."""

    name = "ici"

    def repartition(self, tables, key_names, num_workers):
        t0 = time.perf_counter()
        tables = self._ensure_rows(tables)
        w = num_workers
        assert len(tables) == w, (len(tables), w)
        # metadata phase (rendezvous handshake): one pass hashes every
        # source row to its destination (W for an invalid row) and counts
        # the (source, destination) rows. One read-back sizes the receive
        # buffers.
        pids, counts = partition_histogram(
            [[t.columns[k] for k in key_names] for t in tables],
            [t.validity for t in tables], w)
        counts = counts.cpu().numpy()
        kernel_ops.count_dispatch("partition")
        per_dst = counts.sum(axis=0)
        out_cap = _pow2(int(per_dst.max()))
        out = self._repartition_fused(tables, pids, per_dst, out_cap)
        self.stats.rounds += 1
        moved = int(counts.sum() - np.trace(counts))  # off-diagonal rows move
        self.stats.rows_moved += moved
        self.stats.bytes_moved += moved * _row_bytes(tables[0])
        self.stats.seconds += time.perf_counter() - t0
        return out

    @staticmethod
    def _repartition_fused(tables: Tables, pids: torch.Tensor,
                           per_dst: np.ndarray, out_cap: int) -> Tables:
        """Data phase: destination d receives the rows whose pid is d in
        flat source-major, row-ascending order, compacted to the front of
        an ``[out_cap]`` table (one stable sort of the pids, then one gather
        per column). Dead slots hold the last flat row, as the reference's
        clamped gather leaves them."""
        w = len(tables)
        dev = pids.device
        last = pids.shape[0] - 1
        order = torch.sort(pids, stable=True).indices
        starts = np.concatenate([[0], np.cumsum(per_dst)[:-1]])
        j = torch.arange(out_cap, dtype=torch.int64, device=dev)
        start = torch.as_tensor(starts, dtype=torch.int64, device=dev)
        count = torch.as_tensor(per_dst, dtype=torch.int64, device=dev)
        valid = j[None, :] < count[:, None]                  # [W_dst, out_cap]
        pos = torch.clamp(start[:, None] + j[None, :], max=last)
        idx = torch.where(valid, order.index_select(0, pos.reshape(-1))
                          .reshape(w, out_cap), last)
        flat = _gather_rows(tables, idx.reshape(-1), valid.reshape(-1))
        return [TorchTable({n: a[d * out_cap:(d + 1) * out_cap]
                            for n, a in flat.columns.items()},
                           flat.validity[d * out_cap:(d + 1) * out_cap],
                           flat.schema)
                for d in range(w)]

    def broadcast(self, tables, num_workers):
        t0 = time.perf_counter()
        tables = self._ensure_rows(tables)
        # metadata phase: the valid count sizes the replica, so dead padding
        # is compacted away before it is handed to every worker
        validity = torch.cat([t.validity for t in tables])
        rows = int(validity.sum())
        cap = _pow2(rows)
        last = validity.shape[0] - 1
        idx = torch.full((cap,), last, dtype=torch.int64,
                         device=validity.device)
        idx[:rows] = torch.nonzero(validity).squeeze(1)
        live = torch.arange(cap, device=validity.device) < rows
        # every worker shares the one replica: no operator writes into its
        # input in place
        out = [_gather_rows(tables, idx, live)] * num_workers
        self.stats.rounds += 1
        self.stats.rows_moved += rows * (num_workers - 1)
        self.stats.bytes_moved += (rows * (num_workers - 1)
                                   * _row_bytes(tables[0]))
        self.stats.seconds += time.perf_counter() - t0
        return out


class HostExchange(ExchangeProtocol):
    """Host-staged exchange: the HttpExchange baseline.

    Results are serialized into *pages* (the smallest unit of transmission,
    ``_PAGE_ROWS`` rows), the consumer fetches pages with a request/reply
    protocol, and all of it transits CPU memory: serialize -> page -> fetch
    -> deserialize, with pickle as the page codec."""

    name = "host"

    @staticmethod
    def _to_pages(cols: dict, validity: np.ndarray) -> List[bytes]:
        n = validity.shape[0]
        pages = []
        for lo in range(0, max(n, 1), _PAGE_ROWS):
            hi = min(lo + _PAGE_ROWS, n)
            page = {k: v[lo:hi] for k, v in cols.items()}
            page["__validity"] = validity[lo:hi]
            pages.append(pickle.dumps(page, protocol=4))
        return pages

    @staticmethod
    def _to_host(tables: Tables):
        """device -> host staging: (name -> per-worker arrays, validity
        per worker, bytes staged)."""
        cols = {n: [t.columns[n].cpu().numpy() for t in tables]
                for n in tables[0].column_names}
        validity = [t.validity.cpu().numpy() for t in tables]
        return cols, validity, sum(a.nbytes for v in cols.values() for a in v)

    @staticmethod
    def _to_device(cols: dict, validity: np.ndarray, schema,
                   device) -> TorchTable:
        return TorchTable({n: torch.from_numpy(a).to(device)
                           for n, a in cols.items()},
                          torch.from_numpy(validity).to(device), dict(schema))

    def repartition(self, tables, key_names, num_workers):
        t0 = time.perf_counter()
        tables = self._ensure_rows(tables)
        device, schema = tables[0].device, tables[0].schema
        host_cols, validity, staged = self._to_host(tables)
        self.stats.host_staged_bytes += staged

        w = num_workers
        # only the live rows are hashed: a dead row's id is never read
        live = np.concatenate(validity)
        hashed = np.zeros(live.shape[0], dtype=np.int32)
        hashed[live] = rel.hash_combine(
            [torch.from_numpy(np.concatenate(host_cols[k])[live])
             for k in key_names]).numpy()
        bounds = np.cumsum([0] + [v.shape[0] for v in validity])
        pid = [hashed[bounds[s]:bounds[s + 1]] % w for s in range(w)]

        # upstream: serialize each (src, dst) partition into pages
        inboxes: List[List[bytes]] = [[] for _ in range(w)]
        for src in range(w):
            mask = validity[src]
            for dst in range(w):
                sel = mask & (pid[src] == dst)
                if not sel.any():
                    continue
                part = {n: a[src][sel] for n, a in host_cols.items()}
                inboxes[dst].extend(self._to_pages(part, np.ones(sel.sum(), bool)))

        # downstream: fetch + deserialize pages, assemble worker tables
        per_worker = []
        total_bytes = 0
        for dst in range(w):
            rows = {n: [] for n in host_cols}
            vals = []
            for page_bytes in inboxes[dst]:
                total_bytes += len(page_bytes)
                page = pickle.loads(page_bytes)
                vals.append(page.pop("__validity"))
                for n, a in page.items():
                    rows[n].append(a)
            cnt = sum(v.shape[0] for v in vals) if vals else 0
            per_worker.append((rows, vals, cnt))

        cap = _pow2(max(c for _, _, c in per_worker))
        out, out_bytes = [], 0
        for rows, vals, cnt in per_worker:
            cols = {n: np.zeros((cap,) + a[0].shape[1:], dtype=a[0].dtype)
                    for n, a in host_cols.items()}
            valid = np.zeros(cap, dtype=bool)
            if cnt:
                for n in host_cols:
                    cols[n][:cnt] = np.concatenate(rows[n], axis=0)
                valid[:cnt] = np.concatenate(vals)
            out_bytes += sum(a.nbytes for a in cols.values())
            # host -> device staging
            out.append(self._to_device(cols, valid, schema, device))
        self.stats.rounds += 1
        self.stats.bytes_moved += total_bytes
        self.stats.rows_moved += int(sum(v.sum() for v in validity))
        self.stats.host_staged_bytes += out_bytes
        self.stats.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, tables, num_workers):
        t0 = time.perf_counter()
        tables = self._ensure_rows(tables)
        device, schema = tables[0].device, tables[0].schema
        host_cols, validity, staged = self._to_host(tables)
        self.stats.host_staged_bytes += staged
        w = num_workers
        flat_valid = np.concatenate(validity)
        flat_cols = {n: np.concatenate(a) for n, a in host_cols.items()}
        pages = self._to_pages({n: a[flat_valid] for n, a in flat_cols.items()},
                               np.ones(int(flat_valid.sum()), bool))
        total = sum(len(p) for p in pages) * (w - 1)
        cnt = int(flat_valid.sum())
        cap = _pow2(cnt)
        cols = {}
        for n, a in flat_cols.items():
            buf = np.zeros((cap,) + a.shape[1:], dtype=a.dtype)
            buf[:cnt] = a[flat_valid]
            cols[n] = buf
        ov = np.zeros(cap, bool)
        ov[:cnt] = True
        # host -> device staging, one copy per worker
        out = [self._to_device(cols, ov, schema, device) for _ in range(w)]
        self.stats.rounds += 1
        self.stats.bytes_moved += total
        self.stats.rows_moved += cnt * (w - 1)
        self.stats.host_staged_bytes += w * sum(a.nbytes for a in cols.values())
        self.stats.seconds += time.perf_counter() - t0
        return out
