"""The port's fault-tolerant training runtime (the counterpart of
``repro.runtime``; the elastic resharding of ``repro.runtime.elastic``
waits for the port's sharding policy)."""

from .fault import (FailureInjector, StragglerMonitor, TrainLoop,  # noqa: F401
                    WorkerFailure)
