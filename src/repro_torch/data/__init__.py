"""The port's training data pipeline (the counterpart of ``repro.data``)."""

from .pipeline import TokenPipeline  # noqa: F401
