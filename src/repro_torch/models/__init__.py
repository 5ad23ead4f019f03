"""Model zoo of the port: every family's LMs (``build_model``) and the
sharding policy (``models.sharding``), the counterparts of
``repro.models``."""

from .model import LMModel, build_model  # noqa: F401
