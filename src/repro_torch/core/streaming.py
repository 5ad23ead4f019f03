"""Morsel-driven streaming scan (the port of ``repro.core.streaming``).

* ``HostMorsel``       -- one worker's scan unit in host memory, before the
                          transfer.
* ``MorselPrefetcher`` -- a bounded-queue background producer: while the
                          consumer computes on step N, the prefetch thread
                          reads step N+1 (one morsel per worker) and copies
                          it to the device.
* ``ScanStats``        -- per-scan counters.
* ``empty_morsel`` / ``stacked_morsel`` -- the scan steps of the chunked
                          storage formats (``repro_torch.storage``): one
                          chunk per worker, read straight into the morsel's
                          buffer.

Storage backends implement ``TableSource._host_morsels`` (host-side reads
only); ``TableSource.scan`` and ``TableSource.stream`` in ``session.py``
copy its steps to the device inline or through a prefetcher.

On a CUDA device the copy runs from pinned host memory on a side stream,
and the producer records an event after it; the consumer makes its own
stream wait on that event before the morsel's first use, and marks each
tensor as used by its stream so the caching allocator cannot hand the
memory back to the side stream while a kernel still reads it. Without the
wait, the copy would race the kernel that reads the morsel.

On a mesh (``launch.mesh.EngineMesh``, the counterpart of the reference's
``sharding=``) each step's morsel w goes to worker w's device: the
prefetcher keeps one side stream and records one event a step on each
CUDA device of the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..device import indexed
from .table import TorchTable


@dataclasses.dataclass
class ScanStats:
    """Counters for one table's scan activity within a query."""

    bytes_read: int = 0          # bytes read from storage (post-skipping)
    bytes_transferred: int = 0   # bytes placed into device memory
    chunks_total: int = 0        # chunks considered by the scan
    chunks_skipped: int = 0      # chunks pruned by zone-map stats
    morsels: int = 0             # morsel steps produced (one morsel per worker)
    read_seconds: float = 0.0    # producer: storage read + host->device copy
    wait_seconds: float = 0.0    # consumer: blocked waiting on the queue
    compute_seconds: float = 0.0 # consumer: time between dequeues

    @property
    def prefetch_overlap(self) -> float:
        """Fraction of read+transfer time hidden behind consumer compute."""
        if self.read_seconds <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.wait_seconds / self.read_seconds)

    def summary(self) -> Dict[str, float]:
        """Counters as a plain dict, with derived ``prefetch_overlap``."""
        d = dataclasses.asdict(self)
        d["prefetch_overlap"] = round(self.prefetch_overlap, 4)
        return d


@dataclasses.dataclass
class HostMorsel:
    """One scan unit in host memory: ``[cap, ...]`` column buffers plus
    validity, ready for one device copy. ``pinned`` holds the pinned
    tensors whose memory the buffers view (column name -> tensor, the
    validity under ``None``) when they were allocated pinned: the copy
    starts from those tensors, so torch's caching host allocator keeps each
    block until its copy has completed."""

    columns: Dict[str, np.ndarray]
    validity: np.ndarray
    schema: Dict[str, object]
    pinned: Optional[Dict[Optional[str], torch.Tensor]] = None

    def nbytes(self) -> int:
        """Host bytes this morsel occupies (columns + validity)."""
        total = self.validity.nbytes
        for a in self.columns.values():
            total += a.nbytes
        return int(total)


_TORCH_OF_NP = {np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.bool_): torch.bool,
                np.dtype(np.uint8): torch.uint8}


def _host_buffer(shape, dtype, pin: bool):
    """An uninitialised host buffer that owns writable memory: a numpy
    array, or with ``pin`` the numpy view of a pinned torch tensor, which
    is returned beside it (else None)."""
    if not pin:
        return np.empty(shape, dtype), None
    t = torch.empty(shape, dtype=_TORCH_OF_NP[np.dtype(dtype)],
                    pin_memory=True)
    return t.numpy(), t


def empty_morsel(schema: Dict[str, object], num_workers: int
                 ) -> List[HostMorsel]:
    """One step of capacity-1, zero-valid-row morsels with the scan's
    schema (keeps downstream operators fed when a scan prunes every
    chunk: each worker's aggregations and joins still see one batch)."""
    step = []
    for _ in range(num_workers):
        cols = {c: np.zeros(d.storage_shape(1), dtype=d.np_dtype())
                for c, d in schema.items()}
        step.append(HostMorsel(cols, np.zeros(1, dtype=bool), dict(schema)))
    return step


def stacked_morsel(cols, schema, num_workers: int, assigned, cap: int,
                   read, pin: bool = False) -> List[HostMorsel]:
    """One scan step of the chunked storage formats: worker k's morsel of
    capacity ``cap`` holds chunk ``assigned[k]`` (the reference's row k of
    its ``[W, cap]`` morsel), its tail dead and zeroed; workers past the
    last assigned chunk get all-dead morsels.

    ``read(col, chunk, out)`` writes that chunk's column values into the
    front of ``out``, the morsel's buffer (with ``pin`` pinned memory, which
    the device copy starts from), and returns how many rows it wrote. A
    worker's live rows are those its chunk's columns were read with (none
    without columns, as in the reference).
    """
    cap = max(cap, 1)
    step = []
    for wi in range(num_workers):
        chunk = assigned[wi] if wi < len(assigned) else None
        valid, owner = _host_buffer(cap, np.bool_, pin)
        owners = {None: owner}
        bufs = {}
        n = 0
        for c in cols:
            d = schema[c]
            buf, owner = _host_buffer(d.storage_shape(cap), d.np_dtype(), pin)
            if chunk is not None:
                n = read(c, chunk, buf)
            buf[n:] = 0
            bufs[c], owners[c] = buf, owner
        valid[:n] = True
        valid[n:] = False
        step.append(HostMorsel(bufs, valid, {c: schema[c] for c in cols},
                               owners if pin else None))
    return step


def _host_tensor(a, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a))).to(dtype)
    return t.pin_memory() if pin and not t.is_pinned() else t


def worker_devices(device, num_workers: int, mesh=None) -> List[torch.device]:
    """The device of each of ``num_workers`` workers, with its index:
    ``mesh``'s placement (``EngineMesh.worker_devices``), or ``device``
    for every worker off the mesh."""
    if mesh is None:
        return [indexed(device)] * num_workers
    return mesh.worker_devices(num_workers)


def morsel_to_device(morsel, device: torch.device,
                     stream: Optional["torch.cuda.Stream"] = None
                     ) -> TorchTable:
    """Copy a host morsel to ``device`` in each column's physical dtype
    (a ``TorchTable`` passes through: a source whose ``scan`` yields
    device tables).

    For a CUDA device the copy is asynchronous from pinned memory (the
    morsel's own pinned buffers, else a pinned copy) on ``stream`` (the
    current stream if None); the caller synchronises with it before use
    (``MorselPrefetcher`` records and waits on an event)."""
    if isinstance(morsel, TorchTable):
        return morsel
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    own = morsel.pinned or {}
    host = {n: _host_tensor(own.get(n, a), morsel.schema[n].torch_dtype(),
                            on_cuda)
            for n, a in morsel.columns.items()}
    hvalid = _host_tensor(own.get(None, morsel.validity), torch.bool, on_cuda)
    if not on_cuda:
        return TorchTable(host, hvalid, dict(morsel.schema))
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        cols = {n: t.to(device, non_blocking=True) for n, t in host.items()}
        validity = hvalid.to(device, non_blocking=True)
    return TorchTable(cols, validity, dict(morsel.schema))


_SENTINEL = object()


class MorselPrefetcher:
    """Async double-buffered storage->device prefetcher.

    A daemon thread drains ``host_morsels`` (each item one scan step: a list
    of one ``HostMorsel`` per worker), copies the step's morsels to
    ``device`` (on a ``mesh``, morsel w to worker w's device) and pushes
    the list of tables into a bounded queue of ``depth`` slots. Iteration
    is single-consumer; abandoning it early stops the producer, and
    producer exceptions re-raise in the consumer.

    The bound is also **bytes-aware**: with a ``host_budget``
    (``core.spill.HostMemoryBudget``, shared with the spill manager's host
    tier) or a private ``max_bytes`` cap, the producer blocks before each
    step until the step's host bytes (its morsels' buffers, pinned for a
    CUDA device) fit the budget. The consumer gives them back when it takes
    the step, once the step's copy has completed.
    """

    def __init__(self, host_morsels: Iterator[List[HostMorsel]], device,
                 depth: int = 2, stats: Optional[ScanStats] = None,
                 host_budget=None, max_bytes: Optional[int] = None,
                 mesh=None):
        self.stats = stats if stats is not None else ScanStats()
        self.device = torch.device(device)
        self._mesh = mesh
        self._gen = host_morsels
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        if host_budget is None and max_bytes is not None:
            from .spill import HostMemoryBudget
            host_budget = HostMemoryBudget(max_bytes)
        self._budget = host_budget
        self._closed = threading.Event()
        devices = [indexed(self.device)] + (list(mesh.devices) if mesh
                                            else [])
        # one side stream a CUDA device (keyed by the device with its
        # index, as its tables report it); the session's device's first
        self._streams = {d: torch.cuda.Stream(d)
                         for d in dict.fromkeys(devices) if d.type == "cuda"}
        self._stream = self._streams.get(devices[0])
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="morsel-prefetch")

    # -- producer (background thread) ---------------------------------------
    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        # the producer's device work (the copies, and whatever a source
        # whose scan yields device tables does) runs on the side stream,
        # which the event recorded after each step covers
        side = (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())
        try:
            with side:
                self._produce_steps()
        except BaseException as exc:  # noqa: BLE001 -- re-raised by consumer
            self._put(exc)

    def _produce_steps(self) -> None:
        it = iter(self._gen)
        while not self._closed.is_set():
            t0 = time.perf_counter()
            try:
                hosts = next(it)
            except StopIteration:
                break
            nbytes = sum(h.nbytes() for h in hosts)
            if self._budget is not None and not self._budget.acquire(
                    nbytes, stop=self._closed.is_set):
                return
            devs = worker_devices(self.device, len(hosts), self._mesh)
            tables = [morsel_to_device(h, d, self._streams.get(d))
                      for h, d in zip(hosts, devs)]
            # one event a CUDA device, recorded after its copies, and the
            # host bytes those copies read
            events, parts = {}, {}
            for h, t in zip(hosts, tables):
                d = t.device
                if d.type == "cuda" and d not in events:
                    events[d] = torch.cuda.Event()
                    events[d].record(self._streams[d])
                parts[d] = parts.get(d, 0) + h.nbytes()
            parts = [(events.get(d), n) for d, n in parts.items()]
            self.stats.read_seconds += time.perf_counter() - t0
            self.stats.bytes_transferred += nbytes
            self.stats.morsels += 1
            if not self._put((tables, events, parts)):
                self._give_back(parts)
                return
        self._put(_SENTINEL)

    def _give_back(self, parts) -> None:
        """Return a step's host bytes to the budget once their copies (the
        readers of its host buffers) have completed: each device's bytes
        after that device's event."""
        if self._budget is not None:
            for event, nbytes in parts:
                self._budget.release_after(event, nbytes)

    # -- consumer ------------------------------------------------------------
    def close(self) -> None:
        """Stop the producer thread and wait until it has exited (also
        called when iteration ends): it stops within one step's copy. The
        budget held by steps still queued is given back."""
        self._closed.set()
        if (self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("MorselPrefetcher: the producer thread "
                                   "did not stop within 30 s")
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, tuple):
                self._give_back(item[2])

    def __iter__(self) -> Iterator[List[TorchTable]]:
        self._thread.start()
        try:
            last = None
            while True:
                t0 = time.perf_counter()
                item = self._q.get()
                now = time.perf_counter()
                self.stats.wait_seconds += now - t0
                if last is not None:
                    self.stats.compute_seconds += t0 - last
                last = now
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                tables, events, parts = item
                self._give_back(parts)
                for table in tables:
                    event = events.get(table.device)
                    if event is None:
                        continue
                    consumer = torch.cuda.current_stream(table.device)
                    consumer.wait_event(event)
                    for t in list(table.columns.values()) + [table.validity]:
                        t.record_stream(consumer)
                yield tables
        finally:
            self.close()
