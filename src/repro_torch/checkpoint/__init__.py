"""The port's checkpoints (the counterpart of ``repro.checkpoint``)."""

from .ckpt import CheckpointManager, restore_latest  # noqa: F401
