"""Session & catalog (the port of ``repro.core.session``).

A ``Session`` binds a catalog of tables to an execution configuration and
runs logical plans through the ``Driver``::

    from repro_torch.core.session import Session
    from repro_torch.tpch import dbgen, queries

    catalog = dbgen.load_catalog(sf=0.01)
    session = Session(catalog)                  # device=None: the GPU
    out = session.execute(queries.build_query(6, catalog))  # name -> column
    top = (session.table("orders").group_by("o_orderpriority")
           .agg(n=("count", None)).collect())   # the fluent builder

``Session(device=None)`` means ``"cuda"`` and raises when no GPU is present;
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..device import resolve_device
from .builder import QueryBuilder
from .driver import Driver, ExecutionContext
from .exchange import ExchangeProtocol
from .optimizer import OptimizerConfig, optimize
from .plan import PlanNode
from .streaming import HostMorsel, MorselPrefetcher, ScanStats


class TableSource:
    """Abstract storage backend for one catalog table. Backends implement
    ``_host_morsels`` (host-side reads); ``stream`` wraps the reads in a
    prefetcher that copies them to the device."""

    name: str
    schema: dict
    # column sets that uniquely identify a row (primary/candidate keys)
    unique_keys: tuple = ()

    def num_rows(self) -> int:
        """Total rows in the table (the statistic plans are sized from)."""
        raise NotImplementedError

    def _host_morsels(self, columns, batch_rows: int,
                      stats: Optional[ScanStats] = None,
                      num_workers: int = 1) -> Iterator[List[HostMorsel]]:
        """Host-side scan steps (storage reads only, no device copy): each
        step is a list of one morsel per worker."""
        raise NotImplementedError

    def stream(self, columns, batch_rows: int, device, prefetch_depth: int = 2,
               stats: Optional[ScanStats] = None,
               num_workers: int = 1) -> MorselPrefetcher:
        """Asynchronous scan: a background thread reads step N+1 and
        copies its morsels to ``device`` while step N computes."""
        return MorselPrefetcher(self._host_morsels(columns, batch_rows,
                                                   stats=stats,
                                                   num_workers=num_workers),
                                device, depth=prefetch_depth, stats=stats)


class InMemoryTable(TableSource):
    """Numpy-backed table; rows are range-partitioned across workers and
    scanned in ``batch_rows`` morsels.

    Worker k owns rows ``[k * per_worker, (k + 1) * per_worker)`` with
    ``per_worker = ceil(n / W)``; step b gives every worker its rows
    ``[b * batch_rows, (b + 1) * batch_rows)`` of that range in a morsel of
    the same capacity, a short worker's padded with dead rows (the
    reference's split). At W = 1 the morsels are views of the arrays."""

    def __init__(self, name: str, data: Dict[str, np.ndarray], schema: dict,
                 unique_keys: tuple = ()):
        self.name = name
        self.data = {k: np.asarray(v, dtype=schema[k].np_dtype())
                     for k, v in data.items()}
        self.schema = dict(schema)
        self.unique_keys = tuple(tuple(u) for u in unique_keys)
        self._n = len(next(iter(self.data.values()))) if self.data else 0

    def num_rows(self) -> int:
        return self._n

    def _host_morsels(self, columns, batch_rows: int,
                      stats: Optional[ScanStats] = None,
                      num_workers: int = 1) -> Iterator[List[HostMorsel]]:
        cols = list(columns) if columns else list(self.data.keys())
        schema = {c: self.schema[c] for c in cols}
        n = self._n
        per_worker = math.ceil(n / num_workers) if n else 1
        for lo in range(0, per_worker, batch_rows):
            hi = min(lo + batch_rows, per_worker)
            cap = hi - lo
            step = []
            for wk in range(num_workers):
                s = min(wk * per_worker + lo, n)
                e = min(wk * per_worker + hi, n)
                if e - s == cap:        # a whole morsel: views, no copy
                    bufs = {c: self.data[c][s:e] for c in cols}
                else:                   # a short worker: dead padding
                    bufs = {}
                    for c in cols:
                        d = schema[c]
                        bufs[c] = np.zeros(d.storage_shape(cap), d.np_dtype())
                        bufs[c][:e - s] = self.data[c][s:e]
                validity = np.zeros(cap, dtype=bool)
                validity[:e - s] = True
                if stats is not None:
                    stats.bytes_read += sum(b.nbytes for b in bufs.values())
                step.append(HostMorsel(bufs, validity, schema))
            yield step


class Catalog:
    """Named ``TableSource`` registry (a Presto connector catalog)."""

    def __init__(self):
        self._tables: Dict[str, TableSource] = {}

    @classmethod
    def from_numpy(cls, tables: Dict[str, Dict[str, np.ndarray]],
                   schemas: Dict[str, dict],
                   unique_keys: Optional[Dict[str, tuple]] = None
                   ) -> "Catalog":
        """A catalog of ``InMemoryTable``s over host arrays, e.g. the tables
        another engine generated, so that both scan the same bytes.
        ``unique_keys`` maps a table name to its tuple of key-column
        tuples."""
        cat = cls()
        for name, data in tables.items():
            cat.register(InMemoryTable(name, data, schemas[name],
                                       (unique_keys or {}).get(name, ())))
        return cat

    def register(self, source: TableSource):
        """Add or replace a table."""
        self._tables[source.name] = source

    def get(self, name: str) -> TableSource:
        """Look up a table source; raises ``KeyError`` if unknown."""
        return self._tables[name]

    def tables(self):
        """Registered table names."""
        return list(self._tables)


@dataclasses.dataclass
class Session:
    """The port's entry point: a catalog bound to an execution config.

    ``device=None`` means ``"cuda"`` and raises when there is no GPU.
    ``num_workers`` workers run on the one device, each with its own
    operators, and ``exchange`` moves rows between them (``None`` means
    ``ICIExchange()``; ``HostExchange()`` stages through host memory). Plan
    a query for the same worker count::

        session = Session(catalog, num_workers=4, exchange=HostExchange())
        out = session.execute(queries.build_query(5, catalog, num_workers=4))

    Each ``execute`` runs with a ``clone()`` of the protocol (zeroed
    stats); ``executor_stats()['exchanges']`` holds that query's counters.
    """

    catalog: Catalog
    batch_rows: int = 8192
    prefetch_depth: int = 2
    device: Optional[object] = None
    num_workers: int = 1
    exchange: Optional[ExchangeProtocol] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.last_driver: Optional[Driver] = None

    def context(self) -> ExecutionContext:
        """Snapshot this session's execution config for one Driver run."""
        exchange = self.exchange.clone() if self.exchange is not None else None
        return ExecutionContext(catalog=self.catalog, device=self.device,
                                num_workers=self.num_workers,
                                exchange=exchange,
                                batch_rows=self.batch_rows,
                                prefetch_depth=self.prefetch_depth)

    def table(self, name: str, columns=None) -> "QueryBuilder":
        """Fluent builder over a catalog table, bound to this session."""
        return QueryBuilder.scan(self.catalog, name, columns, session=self)

    def optimizer_config(self) -> OptimizerConfig:
        """The optimizer's configuration for this session's worker count."""
        return OptimizerConfig(num_workers=self.num_workers)

    def optimize(self, plan: PlanNode) -> PlanNode:
        """Run the optimizer's rule pipeline over a logical plan."""
        return optimize(plan, self.catalog, config=self.optimizer_config())

    def execute(self, plan: PlanNode) -> Dict[str, np.ndarray]:
        """Execute one plan; returns name -> numpy column of valid rows."""
        driver = Driver(self.context())
        self.last_driver = driver
        return driver.collect(plan)

    def executor_stats(self) -> Dict[str, object]:
        """Stats from the most recent ``execute`` ({} before any)."""
        return ({} if self.last_driver is None
                else self.last_driver.executor_stats())
