"""PyTorch/CUDA port of the ``repro`` query engine.

The JAX package ``repro`` stays the reference; this package keeps its own
copies of the host-side pieces it needs and never imports ``jax`` or
``repro``. Module names mirror the reference (``core.table``,
``core.operators``, ``kernels.segmented_agg``, ...) so each counterpart is
easy to find. Every kernel that the reference wrote in Pallas for the TPU is
a CUDA C++ kernel under ``kernels/csrc/``, built with ``nvcc`` at first use,
with a plain PyTorch version beside it that runs for CPU tensors.

Entry point::

    from repro_torch.core.session import Session
    from repro_torch.tpch import dbgen, queries

    catalog = dbgen.load_catalog(sf=1)
    out = Session(catalog, batch_rows=1 << 20).execute(
        queries.build_query(1, catalog))

``Session(device=None)`` runs on ``"cuda"`` and raises when no GPU is
present; pass ``device="cpu"`` to run the plain versions. W workers run
on the one device with ``Session(catalog, num_workers=W,
exchange=ICIExchange() | HostExchange())`` and a plan from
``queries.build_query(q, catalog, num_workers=W)``; with
``mesh=launch.mesh.make_engine_mesh(W)`` each worker runs on a card of its
own (``EngineMesh([torch.device("cuda:0")])`` keeps them on one card
through the same staged exchange).

Serving: ``session.submit(plan)`` returns a handle, ``session.gather(*h)``
and ``session.run(plan)`` wait for results; the scheduler behind them
(``SchedulerConfig(batching=True)`` stacks compatible small queries into
one scan) runs on the session's device.
"""

from .core.exchange import HostExchange, ICIExchange
from .core.scheduler import QueryRejected, SchedulerConfig
from .core.session import ExecutionOptions, Session
from .device import resolve_device

__all__ = ["ExecutionOptions", "HostExchange", "ICIExchange", "QueryRejected",
           "SchedulerConfig", "Session", "resolve_device"]
