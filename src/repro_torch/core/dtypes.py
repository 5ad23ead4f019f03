"""Column dtypes (the port's copy of ``repro.core.dtypes``).

Logical types are the reference's: numeric columns, ``date32`` (int32 days
since 1970-01-01), ``dict32`` (int32 codes plus a host-side dictionary) and
fixed-width ``bytes`` (uint8[N, W]). TPC-H has no nulls; validity is a
table-level row mask.

On the device the port follows the reference's *physical* layout, which
runs with 64-bit types off: ``int64`` is int32 and ``float64`` is float32.
Integer sums therefore wrap at 2^31 exactly where the reference wraps.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Tuple

import numpy as np
import torch

_EPOCH = datetime.date(1970, 1, 1)

# logical name -> device dtype (64-bit types narrowed, as the reference's
# x64-off layout does)
_TORCH = {
    "int32": torch.int32,
    "int64": torch.int32,
    "float32": torch.float32,
    "float64": torch.float32,
    "bool": torch.bool,
    "date32": torch.int32,
    "dict32": torch.int32,
    "bytes": torch.uint8,
}


@dataclasses.dataclass(frozen=True)
class DType:
    """Logical column type."""

    name: str                      # int32 | int64 | float32 | float64 | bool |
                                   # date32 | dict32 | bytes
    width: int = 0                 # only for 'bytes': fixed row width
    dictionary: Optional[Tuple[str, ...]] = None   # only for 'dict32'

    @property
    def is_numeric(self) -> bool:
        """True for plain int/float columns (arithmetic allowed)."""
        return self.name in ("int32", "int64", "float32", "float64")

    @property
    def is_string(self) -> bool:
        """True for dict-encoded or fixed-width-bytes string columns."""
        return self.name in ("dict32", "bytes")

    def np_dtype(self) -> np.dtype:
        """Numpy storage dtype for one element of this column (host side)."""
        return np.dtype(
            {
                "int32": np.int32,
                "int64": np.int64,
                "float32": np.float32,
                "float64": np.float64,
                "bool": np.bool_,
                "date32": np.int32,
                "dict32": np.int32,
                "bytes": np.uint8,
            }[self.name]
        )

    def torch_dtype(self) -> torch.dtype:
        """Device dtype for one element of this column (physical layout)."""
        return _TORCH[self.name]

    def storage_shape(self, num_rows: int) -> tuple:
        """Array shape for ``num_rows`` values ([N, W] for bytes)."""
        if self.name == "bytes":
            return (num_rows, self.width)
        return (num_rows,)

    def decode(self, code: int) -> str:
        """dict32 code -> string (host-side dictionary lookup)."""
        assert self.name == "dict32" and self.dictionary is not None
        return self.dictionary[code]

    def encode(self, value: str) -> int:
        """dict32 string -> code (host-side dictionary lookup)."""
        assert self.name == "dict32" and self.dictionary is not None
        return self.dictionary.index(value)

    def __repr__(self) -> str:  # keep dictionaries out of reprs
        if self.name == "bytes":
            return f"bytes[{self.width}]"
        if self.name == "dict32":
            n = len(self.dictionary) if self.dictionary else 0
            return f"dict32[{n}]"
        return self.name


INT32 = DType("int32")
INT64 = DType("int64")
FLOAT32 = DType("float32")
FLOAT64 = DType("float64")
BOOL = DType("bool")
DATE32 = DType("date32")


def dict32(values) -> DType:
    """Dictionary-encoded string type over a fixed value domain."""
    return DType("dict32", dictionary=tuple(values))


def bytes_(width: int) -> DType:
    """Fixed-width byte-string type (uint8[N, width] storage)."""
    return DType("bytes", width=width)


def date_to_i32(iso: str) -> int:
    """'1995-03-15' -> days since epoch (int)."""
    y, m, d = (int(p) for p in iso.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


def i32_to_date(days: int) -> str:
    """int32 days-since-epoch -> 'YYYY-MM-DD'."""
    return (_EPOCH + datetime.timedelta(days=int(days))).isoformat()
