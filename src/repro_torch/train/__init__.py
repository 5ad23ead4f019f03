"""Training of the port: AdamW, the train step, gradient compression (the
counterparts of ``repro.train``)."""

from .optimizer import AdamWState, adamw_init, adamw_update, lr_schedule  # noqa: F401
from .train_step import TrainState, make_train_step, train_state_init  # noqa: F401
