"""Tiered-memory spill subsystem (the port of ``repro.core.spill``):
device -> pinned host -> paged disk.

* ``SpillManager``     -- owns one query's device-memory budget. Operators
                          take *reservations* against it (grace join build
                          sides, aggregation accumulators, exchange send
                          buffers); partitions that do not fit move down the
                          hierarchy: device tensors are copied into pinned
                          host tensors, and when the host budget fills,
                          victim partitions are written as ``storage.paged``
                          files (the format ``PagedTableSource`` reads).
                          Every byte crossing a tier boundary is accounted
                          per tier, as in the reference.
* ``HostMemoryBudget`` -- the shared host-bytes meter: the spill manager's
                          host tier and every ``MorselPrefetcher`` draw from
                          the same budget, so prefetched morsels and spilled
                          partitions cannot together exceed the configured
                          host memory.

On a CUDA device the host tier holds pinned tensors from torch's caching
host allocator: ``spill_table`` copies device to host asynchronously on the
source card's current stream and records an event there, and ``restore``
copies each partition back to the card it left, asynchronously on that
card's current stream after that event. A host buffer is read on the host
(the disk tier, ``restore_host``) only after its events, and its bytes go
back to the budget only once every copy that reads it has completed
(``HostMemoryBudget.release_after``).

A partition remembers the device of each worker table it holds. A step of
W worker tables (``spill_step``, the grace join's partitions) is one
``[W, cap]`` partition stacked on the host, whatever cards its tables lie
on, and ``restore_step`` gives worker w's table back on worker w's card;
at W = 1 it is the worker's own table. The bytes and the disk layout are
those of the reference's stacked partition, on a mesh or off it.

Spilled partitions round-trip **bit-exactly**: integer columns are stored
through the paged format's plain-encoded byte pages (its delta encoding is
not wrap-safe for arbitrary int64 data), floats/bools/bytes are plain pages
already, and validity rides along as a ``bool`` column. Shapes are
preserved through a flatten/reshape recorded on the handle. Victim
selection is largest-first; ``SpillCapacityError`` is raised only when the
*disk* ceiling is exceeded.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import dtypes as dt
from .table import TorchTable


class SpillCapacityError(RuntimeError):
    """The spill hierarchy's *disk* ceiling was exceeded (the only tier
    with a hard limit; device/host overflow cascades downward instead)."""


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TierStats:
    """Byte/event counters for one tier boundary of the hierarchy."""

    spilled_bytes: int = 0      # bytes written into this tier
    restored_bytes: int = 0     # bytes read back out of this tier
    spills: int = 0             # partitions written
    restores: int = 0           # partitions read back

    def summary(self) -> Dict[str, int]:
        """Counters as a plain dict (for ``executor_stats`` reporting)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SpillStats:
    """Per-tier accounting for one ``SpillManager`` (one query): ``host``
    counts device->host movement (every spill lands there first), ``disk``
    host->disk victim writes and their restores."""

    host: TierStats = dataclasses.field(default_factory=TierStats)
    disk: TierStats = dataclasses.field(default_factory=TierStats)
    reserved_peak: int = 0      # high-water mark of device reservations
    reserve_denials: int = 0    # reservations that did not fit in full

    @property
    def spilled_bytes(self) -> int:
        """Total bytes that left the device tier (disk writes are host-tier
        bytes moved further down, counted once)."""
        return self.host.spilled_bytes

    def summary(self) -> Dict[str, object]:
        """Nested per-tier counter dict (for ``executor_stats``/explain)."""
        return {
            "host": self.host.summary(),
            "disk": self.disk.summary(),
            "reserved_peak": self.reserved_peak,
            "reserve_denials": self.reserve_denials,
            "spilled_bytes": self.spilled_bytes,
        }


class HostMemoryBudget:
    """Shared host-bytes meter with blocking acquisition.

    One instance is shared by a query's spill manager (non-blocking
    ``try_acquire``: on denial the partition cascades to disk) and its
    prefetchers (blocking ``acquire``: storage reads stall until the
    consumer drains). Progress is guaranteed: a request is always admitted
    when nothing is held, so a single morsel or partition larger than the
    whole budget still flows.

    ``release_after(events, nbytes)`` returns bytes whose buffer
    asynchronous device copies still read: they count as held until the
    event (or each event of a sequence, one a card) has completed. Every
    decision and every reading of ``in_use`` first waits for those
    copies, so the accounting is the reference's, whatever the card's
    progress.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max(int(max_bytes), 0)
        self._in_use = 0
        self._cond = threading.Condition()
        self._pending: List[Tuple[object, int]] = []   # (event, nbytes)
        # pressure relief valve: a blocked acquire() calls this (outside
        # the lock) to ask the holder of the budget to give some back; the
        # sharing SpillManager registers its evict-to-disk hook here
        self.pressure = None      # Optional[Callable[[], bool]]

    def _settle(self) -> None:
        """Wait for the copies behind deferred releases, then release them
        (held lock)."""
        if not self._pending:
            return
        for events, nbytes in self._pending:
            for event in events:
                event.synchronize()
            self._in_use = max(0, self._in_use - nbytes)
        self._pending.clear()
        self._cond.notify_all()

    @property
    def in_use(self) -> int:
        """Bytes currently held against the budget."""
        with self._cond:
            self._settle()
            return self._in_use

    def _fits(self, nbytes: int) -> bool:
        self._settle()
        return self._in_use == 0 or self._in_use + nbytes <= self.max_bytes

    def try_acquire(self, nbytes: int) -> bool:
        """Non-blocking: reserve ``nbytes`` of host memory if it fits."""
        with self._cond:
            if self._fits(nbytes):
                self._in_use += nbytes
                return True
            return False

    def acquire(self, nbytes: int, stop=None) -> bool:
        """Block until ``nbytes`` fits (or ``stop()`` turns true),
        applying pressure to the spill store while waiting."""
        while True:
            with self._cond:
                if self._fits(nbytes):
                    self._in_use += nbytes
                    return True
                if stop is not None and stop():
                    return False
            relief = self.pressure
            if relief is not None and relief():
                continue              # something was evicted: retry now
            with self._cond:
                if self._fits(nbytes):
                    self._in_use += nbytes
                    return True
                if stop is not None and stop():
                    return False
                self._cond.wait(timeout=0.05)

    def release(self, nbytes: int) -> None:
        """Return ``nbytes`` to the budget and wake blocked acquirers."""
        with self._cond:
            self._in_use = max(0, self._in_use - nbytes)
            self._cond.notify_all()

    def release_after(self, events, nbytes: int) -> None:
        """Return ``nbytes`` once ``events`` (a ``torch.cuda.Event`` after
        the copy that reads the buffer, or a sequence of them, one a card)
        have completed; ``None`` or an empty sequence releases now."""
        if events is not None and not isinstance(events, (list, tuple)):
            events = (events,)
        if not events:
            self.release(nbytes)
            return
        with self._cond:
            self._pending.append((tuple(events), nbytes))


# ---------------------------------------------------------------------------
# spilled-partition payloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HostPartition:
    """One spilled partition resident in the host tier: CPU tensors
    (pinned when they came from a CUDA device), validity included, shapes
    preserved; the device each worker table came from (one for a table,
    W for a stacked step's ``[W, cap]`` tensors) and, per source card, the
    event after the copies that filled them (none when they were filled
    on the host)."""

    columns: Dict[str, torch.Tensor]
    validity: torch.Tensor
    schema: Dict[str, dt.DType]
    nbytes: int
    devices: Tuple[torch.device, ...]
    stacked: bool = False
    ready: Dict[torch.device, object] = dataclasses.field(
        default_factory=dict)

    def numpy(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """The host arrays, after the copies that filled them have
        completed."""
        for event in self.ready.values():
            event.synchronize()
        return ({n: a.numpy() for n, a in self.columns.items()},
                self.validity.numpy())


@dataclasses.dataclass
class _DiskPartition:
    """One spilled partition written to a paged file: the codec metadata
    needed to restore it bit-exactly (per column the physical array's
    shape and numpy dtype string)."""

    path_root: str
    file_name: str
    layout: Dict[str, tuple]        # name -> (shape, numpy dtype str)
    schema: Dict[str, dt.DType]
    nbytes: int
    devices: Tuple[torch.device, ...]
    stacked: bool


# physical float/bool dtypes the paged format plain-encodes as-is
_PLAIN_DTYPES = {"float32": dt.FLOAT32, "float64": dt.FLOAT64,
                 "bool": dt.BOOL}


def _flatten_codec(columns: Dict[str, np.ndarray], validity: np.ndarray,
                   schema: Dict[str, dt.DType]):
    """Encode a partition for the paged on-disk format, bit-exactly:
    integer columns as plain byte pages of their element width, floats and
    bools as themselves, bytes columns as ``[rows, width]``; leading dims
    flattened, shapes and physical dtypes kept in the layout."""
    data, disk_schema, layout = {}, {}, {}
    for name, arr in columns.items():
        d = schema[name]
        arr = np.ascontiguousarray(arr)
        layout[name] = (arr.shape, arr.dtype.str)
        if d.name == "bytes":
            data[name] = arr.reshape(-1, d.width)
            disk_schema[name] = dt.bytes_(d.width)
        elif str(arr.dtype) in _PLAIN_DTYPES:
            data[name] = arr.reshape(-1)
            disk_schema[name] = _PLAIN_DTYPES[str(arr.dtype)]
        else:
            item = arr.dtype.itemsize
            flat = arr.reshape(-1)
            data[name] = flat.view(np.uint8).reshape(len(flat), item)
            disk_schema[name] = dt.bytes_(item)
    validity = np.ascontiguousarray(validity).astype(bool, copy=False)
    layout["__validity"] = (validity.shape, validity.dtype.str)
    data["__validity"] = validity.reshape(-1)
    disk_schema["__validity"] = dt.BOOL
    return data, disk_schema, layout


def _restore_codec(reader, layout: Dict[str, tuple],
                   schema: Dict[str, dt.DType]):
    """Invert ``_flatten_codec`` from a ``storage.paged.PagedTable``."""
    columns = {}
    for name, d in schema.items():
        shape, dtype_str = layout[name]
        raw = np.asarray(reader.read_column(name))
        if d.name == "bytes" or str(raw.dtype) in _PLAIN_DTYPES:
            arr = raw
        else:
            arr = np.frombuffer(np.ascontiguousarray(raw).tobytes(),
                                dtype=np.dtype(dtype_str))
        columns[name] = arr.reshape(shape)
    v_shape, _ = layout["__validity"]
    validity = np.asarray(reader.read_column("__validity"),
                          dtype=bool).reshape(v_shape)
    return columns, validity


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor over a host array (no copy for a contiguous one)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


def _to_host(step: List[TorchTable]):
    """The host copy of a step's tables, stacked ``[W, cap]`` when W > 1:
    (name -> tensor with the validity under ``None``, per source card the
    event after its copies). From CUDA devices each table is copied
    asynchronously into its row of pinned tensors on its own card's
    current stream; no tensor crosses from one card to another."""
    tensors = []
    for t in step:
        tensors.append(dict(t.columns))
        tensors[-1][None] = t.validity
    stacked = len(step) > 1
    if not step[0].validity.is_cuda:
        if stacked:
            return ({n: torch.stack([t[n] for t in tensors])
                     for n in tensors[0]}, {})
        return {n: a.clone() for n, a in tensors[0].items()}, {}
    lead = (len(step),) if stacked else ()
    host = {n: torch.empty(lead + tuple(a.shape), dtype=a.dtype,
                           pin_memory=True)
            for n, a in tensors[0].items()}
    for i, t in enumerate(tensors):
        for n, a in t.items():
            (host[n][i] if stacked else host[n]).copy_(a, non_blocking=True)
    ready = {}
    for dev in dict.fromkeys(t.device for t in step):
        # after every copy from this card, each queued on its stream
        ready[dev] = torch.cuda.Event()
        ready[dev].record(torch.cuda.current_stream(dev))
    return host, ready


# ---------------------------------------------------------------------------
# SpillManager
# ---------------------------------------------------------------------------

class SpillManager:
    """Owns one query's device budget and the host/disk spill stores.

    * ``reserve``/``release`` track per-operator device-memory reservations
      against ``device_budget`` (best-effort grants: the caller sizes its
      working set from what it was granted).
    * ``spill_table``/``put_host`` move a partition out of device memory
      into the host store, cascading largest-first victims to paged disk
      files when the host budget fills.
    * ``restore`` brings a partition back as a ``TorchTable`` on the
      device it left (and drops it from the store), ``restore_step`` a
      step's W worker tables each on its own device; ``restore_host``
      returns the host arrays.

    The device budget is the query's, over all its workers and cards.

    One manager serves one query; ``close()`` removes its spill directory.
    """

    def __init__(self, device_budget: int, host_budget: int = 1 << 31,
                 spill_dir: Optional[str] = None,
                 disk_ceiling: int = 1 << 38, device=None):
        self.device_budget = max(int(device_budget), 0)
        self.disk_ceiling = int(disk_ceiling)
        self.device = resolve_device(device)
        self.host = HostMemoryBudget(host_budget)
        self._spill_dir = spill_dir
        self._own_dir: Optional[str] = None
        self._lock = threading.RLock()
        self._reserved: Dict[str, int] = {}
        # host store kept in insertion order; victims picked largest-first
        self._host_store: Dict[object, _HostPartition] = {}
        self._disk_store: Dict[object, _DiskPartition] = {}
        self._disk_in_use = 0
        self._seq = 0
        self.stats = SpillStats()
        self.host.pressure = self._evict_one

    # -- device reservations -------------------------------------------------
    def reserve(self, op: str, want: int, minimum: int = 0) -> int:
        """Grant ``op`` between ``minimum`` and ``want`` bytes of the
        device budget (best effort). The grant never drops below
        ``minimum`` -- over-subscribing the budget if needed so operators
        always make progress -- and is recorded against ``op`` until
        ``release``."""
        want = max(int(want), 0)
        minimum = max(int(minimum), 0)
        with self._lock:
            available = self.device_budget - self.device_reserved()
            granted = max(min(want, available), minimum)
            if granted < want:
                self.stats.reserve_denials += 1
            self._reserved[op] = self._reserved.get(op, 0) + granted
            self.stats.reserved_peak = max(self.stats.reserved_peak,
                                           self.device_reserved())
            return granted

    def release(self, op: str, nbytes: Optional[int] = None) -> None:
        """Return ``op``'s reservation (all of it when ``nbytes`` is
        None)."""
        with self._lock:
            held = self._reserved.get(op, 0)
            if nbytes is None or nbytes >= held:
                self._reserved.pop(op, None)
            else:
                self._reserved[op] = held - nbytes

    def reserved(self, op: str) -> int:
        """Bytes currently reserved by ``op``."""
        with self._lock:
            return self._reserved.get(op, 0)

    def device_reserved(self) -> int:
        """Total device bytes reserved across operators."""
        return sum(self._reserved.values())

    def device_available(self) -> int:
        """Unreserved device budget (negative when over-subscribed via
        ``minimum`` grants)."""
        with self._lock:
            return self.device_budget - self.device_reserved()

    def should_stage(self, nbytes: int) -> bool:
        """True when a transient buffer of ``nbytes`` does not fit the
        unreserved device budget (the exchange path stages such buffers
        through the spill store)."""
        return nbytes > max(self.device_available(), 0)

    # -- spill / restore ------------------------------------------------------
    def spill_table(self, key, table: TorchTable) -> int:
        """Move a device table into the spill hierarchy; returns the bytes
        that left the device tier. From a CUDA device the columns are
        copied into pinned host tensors on the current stream;
        ``restore`` puts the table back on the device it left."""
        return self.spill_step(key, [table])

    def spill_step(self, key, step: List[TorchTable]) -> int:
        """Move a step of W worker tables (of one schema and capacity, on
        any devices) into the spill hierarchy as one partition: ``[W, cap]``
        tensors stacked on the host, or the worker's own table at W = 1.
        Returns the bytes that left the device tier; ``restore_step``
        gives each table back on the device it left."""
        host, ready = _to_host(step)
        validity = host.pop(None)
        return self._put(key, host, validity, step[0].schema,
                         tuple(t.device for t in step), len(step) > 1, ready)

    def put_host(self, key, columns: Dict[str, object],
                 validity, schema: Dict[str, dt.DType]) -> int:
        """Insert host arrays (numpy arrays or CPU tensors) as a spilled
        partition under ``key``; ``restore`` puts it on this manager's
        device."""
        cols = {n: _host_tensor(a) for n, a in columns.items()}
        return self._put(key, cols, _host_tensor(validity), schema,
                         (self.device,), False, {})

    def _put(self, key, columns, validity, schema, devices, stacked,
             ready) -> int:
        nbytes = int(validity.numel() * validity.element_size()
                     + sum(a.numel() * a.element_size()
                           for a in columns.values()))
        part = _HostPartition(columns, validity, dict(schema), nbytes,
                              devices, stacked, ready)
        with self._lock:
            assert key not in self._host_store and key not in self._disk_store, \
                f"duplicate spill key {key!r}"
            self.stats.host.spilled_bytes += nbytes
            self.stats.host.spills += 1
            if self.host.try_acquire(nbytes):
                self._host_store[key] = part
                self._make_room()
            else:
                self._write_disk(key, part)
        return nbytes

    def _make_room(self) -> None:
        """Largest-first victim selection: while the host tier is over
        budget (prefetched morsels share the meter), write the biggest
        resident partition to disk (held lock)."""
        while (self.host.in_use > self.host.max_bytes
               and self._host_store):
            victim = max(self._host_store,
                         key=lambda k: self._host_store[k].nbytes)
            part = self._host_store.pop(victim)
            self.host.release(part.nbytes)
            self._write_disk(victim, part)

    def _evict_one(self) -> bool:
        """Host-budget pressure callback: sink the largest host-tier
        partition to disk so a blocked acquirer (a prefetcher sharing the
        meter) can proceed. Returns True when bytes moved."""
        with self._lock:
            if not self._host_store:
                return False
            victim = max(self._host_store,
                         key=lambda k: self._host_store[k].nbytes)
            part = self._host_store[victim]
            self._write_disk(victim, part)
            del self._host_store[victim]
            self.host.release(part.nbytes)
            return True

    def _write_disk(self, key, part: _HostPartition) -> None:
        if self._disk_in_use + part.nbytes > self.disk_ceiling:
            raise SpillCapacityError(
                f"spill of {part.nbytes} B would exceed the disk ceiling "
                f"({self.disk_ceiling} B, {self._disk_in_use} B in use)")
        from ..storage.paged import write_paged_table
        root = self._dir()
        name = f"spill{self._seq}"
        self._seq += 1
        columns, validity = part.numpy()
        data, disk_schema, layout = _flatten_codec(columns, validity,
                                                   part.schema)
        write_paged_table(root, name, data, disk_schema, row_groups=1)
        self._disk_store[key] = _DiskPartition(root, name, layout,
                                               part.schema, part.nbytes,
                                               part.devices, part.stacked)
        self._disk_in_use += part.nbytes
        self.stats.disk.spilled_bytes += part.nbytes
        self.stats.disk.spills += 1

    def _pop(self, key) -> Tuple[_HostPartition, bool]:
        """Remove ``key`` from whichever tier holds it: (the partition,
        whether its bytes are still held against the host budget). A disk
        partition is read back into (unpinned) host tensors, held by
        nothing."""
        with self._lock:
            if key in self._host_store:
                part = self._host_store.pop(key)
                self.stats.host.restored_bytes += part.nbytes
                self.stats.host.restores += 1
                return part, True
            entry = self._disk_store.pop(key)
            self._disk_in_use -= entry.nbytes
        from ..storage.paged import PagedTable
        reader = PagedTable(entry.path_root, entry.file_name)
        columns, validity = _restore_codec(reader, entry.layout, entry.schema)
        with self._lock:
            self.stats.disk.restored_bytes += entry.nbytes
            self.stats.disk.restores += 1
            self.stats.host.restored_bytes += entry.nbytes
            self.stats.host.restores += 1
        try:
            os.remove(os.path.join(entry.path_root, f"{entry.file_name}.paged"))
        except OSError:
            pass
        part = _HostPartition({n: _host_tensor(a) for n, a in columns.items()},
                              _host_tensor(validity), entry.schema,
                              entry.nbytes, entry.devices, entry.stacked)
        return part, False

    def restore_host(self, key) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                         Dict[str, dt.DType]]:
        """Pop a spilled partition back to host arrays (columns, validity,
        schema), reading it from whichever tier holds it."""
        part, held = self._pop(key)
        columns, validity = part.numpy()
        if held:
            self.host.release(part.nbytes)
        return columns, validity, part.schema

    def restore(self, key) -> TorchTable:
        """Pop a spilled table back into device memory, on the device it
        left (a ``put_host`` partition: this manager's device). From the
        host tier the copy is asynchronous on that card's current stream;
        the partition's host bytes return to the budget once it has
        completed."""
        tables = self._place(*self._pop(key))
        assert len(tables) == 1, f"{key!r} holds a step: use restore_step"
        return tables[0]

    def restore_step(self, key) -> List[TorchTable]:
        """Pop a partition of ``spill_step`` back as its W worker tables,
        each on the device it left: views of the host tensors for a CPU
        worker, an asynchronous copy on each card's current stream for a
        CUDA one (after that card's spill event); the host bytes return to
        the budget once every card's copies have completed."""
        return self._place(*self._pop(key))

    def _place(self, part: _HostPartition, held: bool) -> List[TorchTable]:
        if part.stacked:
            rows = [({n: a[i] for n, a in part.columns.items()},
                     part.validity[i]) for i in range(len(part.devices))]
        else:
            rows = [(part.columns, part.validity)]
        out, done = [], {}
        for (columns, validity), dev in zip(rows, part.devices):
            if dev.type != "cuda":
                out.append(TorchTable(dict(columns), validity,
                                      dict(part.schema)))
                continue
            stream = torch.cuda.current_stream(dev)
            if dev not in done and dev in part.ready:
                stream.wait_event(part.ready[dev])
            done[dev] = stream
            out.append(TorchTable(
                {n: a.to(dev, non_blocking=held) for n, a in columns.items()},
                validity.to(dev, non_blocking=held), dict(part.schema)))
        if held:
            events = []
            for stream in done.values():
                events.append(torch.cuda.Event())
                events[-1].record(stream)
            self.host.release_after(events, part.nbytes)
        return out

    def has(self, key) -> bool:
        """True if ``key`` is resident in the host or disk tier."""
        with self._lock:
            return key in self._host_store or key in self._disk_store

    def tier_of(self, key) -> Optional[str]:
        """'host' | 'disk' | None -- which tier currently holds ``key``."""
        with self._lock:
            if key in self._host_store:
                return "host"
            if key in self._disk_store:
                return "disk"
            return None

    def keys(self) -> List[object]:
        """All spilled partition keys, host tier first."""
        with self._lock:
            return list(self._host_store) + list(self._disk_store)

    def drop(self, key) -> None:
        """Discard a spilled partition without restoring it."""
        with self._lock:
            part = self._host_store.pop(key, None)
            if part is not None:
                self.host.release_after(list(part.ready.values()),
                                        part.nbytes)
                return
            entry = self._disk_store.pop(key, None)
            if entry is None:
                return
            self._disk_in_use -= entry.nbytes
        try:
            os.remove(os.path.join(entry.path_root, f"{entry.file_name}.paged"))
        except OSError:
            pass

    # -- lifecycle ------------------------------------------------------------
    def _dir(self) -> str:
        if self._spill_dir is not None:
            os.makedirs(self._spill_dir, exist_ok=True)
            return self._spill_dir
        if self._own_dir is None:
            self._own_dir = tempfile.mkdtemp(prefix="repro-spill-")
        return self._own_dir

    def close(self) -> None:
        """Release host bytes and delete this manager's spill files
        (counters survive for ``executor_stats``)."""
        self.host.pressure = None
        with self._lock:
            for part in self._host_store.values():
                self.host.release_after(list(part.ready.values()),
                                        part.nbytes)
            self._host_store.clear()
            for entry in self._disk_store.values():
                try:
                    os.remove(os.path.join(entry.path_root,
                                           f"{entry.file_name}.paged"))
                except OSError:
                    pass
            self._disk_store.clear()
            self._disk_in_use = 0
            own, self._own_dir = self._own_dir, None
        if own is not None:
            shutil.rmtree(own, ignore_errors=True)


def spill_run_keys(prefix: str, n: int) -> Iterable[Tuple[str, int]]:
    """Key sequence for ``n`` spilled runs of one operator."""
    return [(prefix, i) for i in range(n)]
