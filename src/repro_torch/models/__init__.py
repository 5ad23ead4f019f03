"""Model zoo of the port: dense decoder LMs (``build_model``), the
counterparts of ``repro.models``."""

from .model import LMModel, build_model  # noqa: F401
