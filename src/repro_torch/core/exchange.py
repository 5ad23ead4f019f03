"""Inter-worker data exchange (the port of ``repro.core.exchange``).

A distributed stage holds one ``TorchTable`` per worker; an exchange takes
the list of the W source workers' tables and returns the list of the W
destination workers' tables.

Two protocols, the paper's UcxExchange / HttpExchange contrast:

* ``ICIExchange``  -- device-native. A metadata phase hashes every row to
  its destination and counts the rows each source worker holds for each
  destination (``partition_histogram``, the ``radix_histogram`` kernel)
  and reads the ``[W_src, W_dst]`` matrix back in one sync to size the
  receive buffers. Data never leaves device memory. Its data phase takes
  one of two paths:

  - off the mesh (``mesh=None``, every worker on one device, the
    reference's "degenerate SPMD"): every column moves once, with one
    gather, straight into the compacted destination tables
    (``_repartition_fused``); a broadcast hands every worker one shared
    replica. The metadata phase is one launch for all W sources.
  - on a mesh (``ICIExchange(mesh=EngineMesh(...))``, worker w's tables
    on ``mesh.device_of(w, W)``): the reference's staged all-to-all. The
    metadata phase launches once for each device, over the sources that
    device holds, and the counts are added on the host. Each source lays
    its rows out into ``[W_dst, part_cap]`` send buffers on its own
    device (``_partition_layout_table``); destination d receives the W
    sources' blocks for d in source order, each block copied device to
    device into its receive buffer on d's device (``_exchange_data``);
    the receive side then compacts to the metadata phase's capacity
    (``_compact_stacked``). A broadcast copies the W (compacted) tables,
    laid end to end, to every destination's device.
* ``HostExchange`` -- host-staged: device -> numpy, partitioned by a numpy
  hash, serialized into pickle pages, deserialized, and copied back to the
  device of each destination worker. It launches no kernel.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import List, Optional, Sequence

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


def _compact_stacked(tables: Sequence[TorchTable], cap: int) -> Tables:
    """Vector compaction (§3.3.2) of every worker's table to ``cap`` rows,
    each on its own device (the reference's ``_compact_stacked``)."""
    return [_compact_to(t, cap) for t in tables]


def maybe_compact(tables: Sequence[TorchTable]) -> Tables:
    """Vector compaction when it at least halves capacity (§3.3.2): every
    worker's table is trimmed to pow2(the largest per-worker valid count),
    with one read-back of the counts (gathered on the first worker's
    device). The driver calls it before a sort; at W=1 it is the
    reference's ``maybe_compact`` of one worker."""
    tables = list(tables)
    dev = tables[0].device
    counts = torch.stack([t.num_valid().to(dev) for t in tables]).tolist()
    cap = _pow2(max(max(counts), 1))
    if cap * 2 > tables[0].capacity:
        return tables
    return _compact_stacked(tables, cap)


# the metadata phase's pids, carried through the send side's compaction
_PID = "__exchange_pid"


def _histogram(sources: dict, w: int):
    """``partition_histogram`` over the sources of one device (source
    index -> (key columns, validity)); each of the W sources not given is
    an empty table on that device, so its row of the ``[W, W]`` counts is
    0. Returns the given sources' pids, laid end to end, and the counts."""
    own_keys, own_valid = next(iter(sources.values()))
    keys, valid = [], []
    for s in range(w):
        k, v = sources.get(s, (None, None))
        if k is None:
            # an int32 empty column: no cast, so no partition_cast count
            k = [c.new_empty((0,) + tuple(c.shape[1:]),
                             dtype=torch.int32 if c.dim() == 1 else c.dtype)
                 for c in own_keys]
            v = own_valid.new_empty(0)
        keys.append(k)
        valid.append(v)
    return partition_histogram(keys, valid, w)


def _partition_layout_table(table: TorchTable, pids: torch.Tensor,
                            num_workers: int, part_cap: int) -> TorchTable:
    """Data phase step 1 on one source worker's device: its rows laid out
    into ``[W_dst, part_cap]`` send buffers, flattened to ``[W_dst *
    part_cap]`` (``relational.partition_layout``; an empty slot holds row
    0). ``pids`` are the metadata phase's destinations of the rows (W for
    a dead row), where the reference hashes the key columns again."""
    gather, valid = rel.partition_layout(pids, table.validity, num_workers,
                                         part_cap)
    gather = gather.long()
    return TorchTable({n: a.index_select(0, gather)
                       for n, a in table.columns.items()},
                      valid, dict(table.schema))


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
    """Device-native exchange (the paper's UcxExchange). Each worker's
    tables stay on the device they arrive on (the execution context's
    placement). With ``mesh`` (a ``launch.mesh.EngineMesh``, the
    reference's switch), or whenever the workers' tables lie on more than
    one device, the data phase is the staged all-to-all, whose blocks move
    device to device; otherwise it is the fused one-device path.

    ``peer_bytes`` counts the bytes of the blocks this instance copied
    between two different devices (0 off the mesh and on a one-device
    mesh); ``ExchangeStats`` counts rows and bytes as the reference does,
    whichever the path."""

    name = "ici"

    def __init__(self, mesh: Optional[object] = None):
        super().__init__()
        self.mesh = mesh
        self.peer_bytes = 0

    def clone(self) -> "ICIExchange":
        """Fresh ICI protocol on the same mesh, zeroed stats."""
        return type(self)(self.mesh)

    def repartition(self, tables, key_names, num_workers):
        t0 = time.perf_counter()
        tables = self._ensure_rows(tables)
        w = num_workers
        assert len(tables) == w, (len(tables), w)
        key_names = tuple(key_names)
        # metadata phase (rendezvous handshake): one pass hashes every
        # source row to its destination (W for an invalid row) and counts
        # the (source, destination) rows. One read-back sizes the receive
        # buffers.
        groups = self._groups(tables)
        pids, counts = self._partition_counts(tables, key_names, groups)
        kernel_ops.count_dispatch("partition")
        per_dst = counts.sum(axis=0)
        out_cap = _pow2(int(per_dst.max()))
        if self.mesh is None and len(groups) == 1:
            out = self._repartition_fused(tables, pids[0], per_dst, out_cap)
        else:
            out = self._repartition_staged(
                tables,
                [p for flat, srcs in zip(pids, groups) for p in
                 torch.split(flat, [tables[s].capacity for s in srcs])],
                counts, out_cap)
        self.stats.rounds += 1
        moved = int(counts.sum() - np.trace(counts))  # off-diagonal rows move
        self.stats.rows_moved += moved
        self.stats.bytes_moved += moved * _row_bytes(tables[0])
        self.stats.seconds += time.perf_counter() - t0
        return out

    def _repartition_staged(self, tables: Tables, pids,
                            counts: np.ndarray, out_cap: int) -> Tables:
        """Data phase on the mesh: staged send buffers, the all-to-all,
        then receive-side compaction to ``out_cap`` (§3.3.2). The send
        side's compaction keeps each row's source worker and keys, so the
        metadata phase's counts stay valid: each source's ``pids`` ride
        through it as one more column."""
        w = len(tables)
        staged = maybe_compact([
            TorchTable({**t.columns, _PID: p}, t.validity, t.schema)
            for t, p in zip(tables, pids)])
        part_cap = self._choose_part_cap(counts)
        sends = [_partition_layout_table(
            TorchTable({n: a for n, a in t.columns.items() if n != _PID},
                       t.validity, t.schema),
            t.columns[_PID], w, part_cap)
            for t in staged]
        out = self._exchange_data(sends, part_cap)
        if out_cap < out[0].capacity:
            out = _compact_stacked(out, out_cap)
        return out

    @staticmethod
    def _groups(tables: Tables) -> List[List[int]]:
        """The sources on each device their tables lie on, in device order
        (one group of all W when every worker shares one device)."""
        devs = [t.device for t in tables]
        return [[s for s, d in enumerate(devs) if d == dev]
                for dev in dict.fromkeys(devs)]

    @staticmethod
    def _partition_counts(tables: Tables, key_names, groups):
        """The metadata phase: (the pids of each device's sources laid end
        to end, W for a dead row; the ``[W_src, W_dst]`` counts as numpy).
        One launch a device takes the sources it holds (all W when they
        share one device), the others given as empty tables on that device
        (their rows of counts stay 0), and the host adds the devices'
        counts."""
        w = len(tables)
        pids, counts = [], np.zeros((w, w), np.int64)
        for srcs in groups:
            flat, cnt = _histogram(
                {s: ([tables[s].columns[k] for k in key_names],
                     tables[s].validity) for s in srcs}, w)
            counts += cnt.cpu().numpy()
            pids.append(flat)
        return pids, counts

    def _choose_part_cap(self, counts: np.ndarray) -> int:
        """Send-buffer sizing from the metadata phase (flow control): the
        largest (source, destination) count, to a power of two."""
        return _pow2(int(counts.max()) if counts.size else 1)

    def _exchange_data(self, sends: Tables, part_cap: int) -> Tables:
        """The all-to-all: destination d receives block d of every
        source's ``[W_dst * part_cap]`` send buffer, in source order, as
        one ``[W_src * part_cap]`` table on its own device. Each block is
        copied device to device (peer copies between cards); nothing passes
        through the host."""
        return self._receive(sends, part_cap)

    def _receive(self, sends: Tables, part_cap: Optional[int]) -> Tables:
        """Each destination d's receive buffer on worker d's device (that
        of ``sends[d]``): from each source in order, its block d of
        ``part_cap`` rows, or its whole table when ``part_cap`` is None."""
        first = sends[0]
        out = []
        for d, dev in enumerate(t.device for t in sends):
            def receive(arrays):
                blocks = [a if part_cap is None
                          else a[d * part_cap:(d + 1) * part_cap]
                          for a in arrays]
                buf = torch.empty((sum(b.shape[0] for b in blocks),)
                                  + tuple(blocks[0].shape[1:]),
                                  dtype=blocks[0].dtype, device=dev)
                at = 0
                for b in blocks:
                    buf[at:at + b.shape[0]].copy_(b, non_blocking=True)
                    at += b.shape[0]
                    if b.device != dev:
                        self.peer_bytes += b.numel() * b.element_size()
                return buf

            cols = {n: receive([t.columns[n] for t in sends])
                    for n in first.column_names}
            out.append(TorchTable(cols, receive([t.validity for t in sends]),
                                  dict(first.schema)))
        return out

    @staticmethod
    def _repartition_fused(tables: Tables, pids: torch.Tensor,
                           per_dst: np.ndarray, out_cap: int) -> Tables:
        """Data phase off the mesh: destination d receives the rows whose
        pid is d in flat source-major, row-ascending order, compacted to the
        front of an ``[out_cap]`` table (one stable sort of the pids, then
        one gather per column). Dead slots hold the last flat row, as the
        reference's clamped gather leaves them."""
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
        dev = tables[0].device
        validity = torch.cat([t.validity.to(dev) for t in tables])
        rows = int(validity.sum())
        if self.mesh is None and len(self._groups(tables)) == 1:
            cap = _pow2(rows)
            last = validity.shape[0] - 1
            idx = torch.full((cap,), last, dtype=torch.int64, device=dev)
            idx[:rows] = torch.nonzero(validity).squeeze(1)
            live = torch.arange(cap, device=dev) < rows
            # every worker shares the one replica: no operator writes into
            # its input in place
            out = [_gather_rows(tables, idx, live)] * num_workers
        else:
            # every destination receives the W (compacted) tables laid end
            # to end in worker order, copied to its own device
            out = self._receive(maybe_compact(tables), None)
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
    -> deserialize, with pickle as the page codec. Destination d's table
    goes to the device of worker d's source table, so on a mesh each
    worker's rows land on its own device."""

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
        schema = tables[0].schema
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
        for dst, (rows, vals, cnt) in enumerate(per_worker):
            cols = {n: np.zeros((cap,) + a[0].shape[1:], dtype=a[0].dtype)
                    for n, a in host_cols.items()}
            valid = np.zeros(cap, dtype=bool)
            if cnt:
                for n in host_cols:
                    cols[n][:cnt] = np.concatenate(rows[n], axis=0)
                valid[:cnt] = np.concatenate(vals)
            out_bytes += sum(a.nbytes for a in cols.values())
            # host -> device staging
            out.append(self._to_device(cols, valid, schema,
                                       tables[dst].device))
        self.stats.rounds += 1
        self.stats.bytes_moved += total_bytes
        self.stats.rows_moved += int(sum(v.sum() for v in validity))
        self.stats.host_staged_bytes += out_bytes
        self.stats.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, tables, num_workers):
        t0 = time.perf_counter()
        tables = self._ensure_rows(tables)
        schema = tables[0].schema
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
        out = [self._to_device(cols, ov, schema, t.device) for t in tables]
        self.stats.rounds += 1
        self.stats.bytes_moved += total
        self.stats.rows_moved += cnt * (w - 1)
        self.stats.host_staged_bytes += w * sum(a.nbytes for a in cols.values())
        self.stats.seconds += time.perf_counter() - t0
        return out
