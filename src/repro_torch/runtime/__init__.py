"""The port's fault-tolerant training runtime (the counterpart of
``repro.runtime``): the training loop with failure recovery
(``runtime.fault``) and the elastic resharding of a training state across
mesh shapes (``runtime.elastic``)."""

from .fault import (FailureInjector, StragglerMonitor, TrainLoop,  # noqa: F401
                    WorkerFailure)
