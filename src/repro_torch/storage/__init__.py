"""Storage layer (the port of ``repro.storage``; paper §2.2).

Two formats, each a ``TableSource`` whose scan steps hold one chunk per
worker and skip chunks by their min/max stats (``zonemap``):

* ``colchunk`` -- the paper's minimal format: one raw binary file per
  (column, chunk), all metadata in the file name, strings as dictionary
  sidecars. A read is one copy of the file's bytes into the morsel's
  (pinned, on a CUDA device) buffer, then one copy to the device.
* ``paged``    -- a Parquet-shaped baseline: one file per table with nested
  file/row-group/page metadata that the read must interpret, and pages
  delta-decoded on the host. It measures the format-overhead gap.

The files are byte-identical to the reference writer's, so either engine
reads what the other wrote::

    from repro_torch.core.session import Session
    from repro_torch.tpch import dbgen, queries

    dbgen.write_dataset("tpch_sf1", sf=1, chunks=8)
    catalog = dbgen.storage_catalog("tpch_sf1")
    out = Session(catalog).execute(queries.build_query(6, catalog))
"""

from .colchunk import ColumnChunkTable, read_column_chunk, write_table
from .paged import PagedTable, PagedTableSource, write_paged_table
from .zonemap import eval_range, may_match
