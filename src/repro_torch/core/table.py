"""TorchTable: the port's counterpart of ``repro.core.table.DeviceTable``.

A batch of rows resident on one device, with the reference's
capacity-plus-validity model:

* ``columns``   -- name -> tensor; every tensor has leading dim ``capacity``.
* ``validity``  -- bool[capacity]; dead rows (filtered out or padding) stay in
                   place until ``compact()`` moves the live ones to the front.
* ``schema``    -- name -> DType (host metadata).

The reference stacks a worker axis ([W, cap]) and vmaps operators over it;
the port runs one worker and keeps plain ``[cap]`` tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.block_prefix_sum import block_prefix_sum
from .dtypes import DType

Schema = Dict[str, DType]


@dataclasses.dataclass
class TorchTable:
    """One device-resident batch: equal-capacity columns + validity mask +
    host-side schema."""

    columns: Dict[str, torch.Tensor]
    validity: torch.Tensor               # bool[capacity]
    schema: Schema

    @property
    def capacity(self) -> int:
        """Static row capacity (valid + dead rows)."""
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        """Device the batch lives on."""
        return self.validity.device

    @property
    def column_names(self) -> List[str]:
        """Column names in insertion order."""
        return list(self.columns.keys())

    def num_valid(self) -> torch.Tensor:
        """Number of live rows (0-d int32 tensor, not synchronised)."""
        return self.validity.sum(dtype=torch.int32)

    def nbytes(self) -> int:
        """Device bytes pinned by this batch (columns + validity)."""
        total = self.validity.numel() * self.validity.element_size()
        for arr in self.columns.values():
            total += arr.numel() * arr.element_size()
        return int(total)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray], schema: Schema,
                   capacity: Optional[int] = None,
                   device=None) -> "TorchTable":
        """Copy host arrays to ``device`` (None means CUDA), zero-padded up
        to ``capacity`` rows, in the physical dtype of each column."""
        dev = resolve_device(device)
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity or max(n, 1)
        assert cap >= n, f"capacity {cap} < rows {n}"
        cols = {}
        for name, arr in data.items():
            dt = schema[name]
            host = np.zeros(dt.storage_shape(cap), dtype=dt.np_dtype())
            host[:n] = np.asarray(arr, dtype=dt.np_dtype())
            cols[name] = torch.from_numpy(host).to(dev, dt.torch_dtype())
        validity = np.zeros(cap, dtype=bool)
        validity[:n] = True
        return TorchTable(cols, torch.from_numpy(validity).to(dev),
                          dict(schema))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Valid rows back to host numpy arrays."""
        validity = self.validity.cpu().numpy()
        return {name: arr.cpu().numpy()[validity]
                for name, arr in self.columns.items()}

    # -- row ops -------------------------------------------------------------
    def select(self, names) -> "TorchTable":
        """Projection to the named columns (no copy)."""
        return TorchTable({n: self.columns[n] for n in names}, self.validity,
                          {n: self.schema[n] for n in names})

    def rename(self, mapping: Dict[str, str]) -> "TorchTable":
        """Rename columns via ``{old: new}`` (no copy)."""
        cols = {mapping.get(n, n): a for n, a in self.columns.items()}
        schema = {mapping.get(n, n): d for n, d in self.schema.items()}
        return TorchTable(cols, self.validity, schema)

    def with_column(self, name: str, arr: torch.Tensor,
                    dtype: DType) -> "TorchTable":
        """Attach one computed column (same capacity)."""
        cols = dict(self.columns)
        cols[name] = arr
        schema = dict(self.schema)
        schema[name] = dtype
        return TorchTable(cols, self.validity, schema)

    def filter(self, mask: torch.Tensor) -> "TorchTable":
        """Mark rows dead where ``mask`` is false (no compaction)."""
        return TorchTable(self.columns, self.validity & mask, self.schema)

    def gather(self, idx: torch.Tensor, valid: torch.Tensor) -> "TorchTable":
        """Take rows at ``idx`` (new capacity = len(idx)); ``valid`` marks
        live output rows and is ANDed with the source row's validity."""
        idx = idx.long()
        cols = {n: a.index_select(0, idx) for n, a in self.columns.items()}
        return TorchTable(cols, self.validity.index_select(0, idx) & valid,
                          self.schema)

    def compact(self) -> "TorchTable":
        """Stream compaction: move valid rows to the front (stable), keeping
        the capacity. The reference's kernel path: the compaction addresses
        come from ``block_prefix_sum``, and rows move with one scatter of
        their indices (dead rows dropped) and one gather per column. Valid
        rows land exactly where the reference puts them; the dead tail
        gathers row 0. The valid count stays on the device."""
        n = self.capacity
        pos, total = block_prefix_sum(self.validity)
        slot = torch.where(self.validity, pos, n).long()
        rows = torch.zeros(n + 1, dtype=torch.int32, device=self.device)
        rows.index_put_((slot,), torch.arange(n, dtype=torch.int32,
                                              device=self.device))
        rows = rows[:n].long()
        cols = {name: a.index_select(0, rows)
                for name, a in self.columns.items()}
        return TorchTable(cols, torch.arange(n, device=self.device) < total,
                          self.schema)

    def pad_to(self, capacity: int) -> "TorchTable":
        """Grow to ``capacity`` rows by appending dead padding rows."""
        if capacity == self.capacity:
            return self
        assert capacity > self.capacity
        pad = capacity - self.capacity

        def grow(a):
            tail = torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                               device=a.device)
            return torch.cat([a, tail])

        cols = {n: grow(a) for n, a in self.columns.items()}
        return TorchTable(cols, grow(self.validity), self.schema)


def concat_tables(tables: List[TorchTable]) -> TorchTable:
    """Concatenate batches along the row axis."""
    assert tables, "concat of zero tables"
    if len(tables) == 1:
        return tables[0]
    names = tables[0].column_names
    cols = {n: torch.cat([t.columns[n] for t in tables]) for n in names}
    validity = torch.cat([t.validity for t in tables])
    return TorchTable(cols, validity, dict(tables[0].schema))


def empty_like_schema(schema: Schema, capacity: int,
                      device=None) -> TorchTable:
    """All-dead table of ``capacity`` rows with the given schema."""
    dev = resolve_device(device)
    cols = {n: torch.zeros(dt.storage_shape(capacity), dtype=dt.torch_dtype(),
                           device=dev)
            for n, dt in schema.items()}
    return TorchTable(cols, torch.zeros(capacity, dtype=torch.bool,
                                        device=dev), dict(schema))
