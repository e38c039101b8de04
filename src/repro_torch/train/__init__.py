"""Training substrate: optimizer, step factories, fault-tolerant trainer."""

from .optimizer import (AdamWConfig, OptState, adamw_update, init_opt_state,
                        lr_schedule, opt_state_from_reference,
                        opt_state_shapes)
from .steps import (build_decode_step, build_prefill_step, build_train_step,
                    lm_loss)
from .trainer import Trainer, TrainerConfig, on_resize

__all__ = ["AdamWConfig", "OptState", "adamw_update", "init_opt_state",
           "lr_schedule", "opt_state_shapes", "build_decode_step",
           "build_prefill_step", "build_train_step", "lm_loss", "Trainer",
           "TrainerConfig", "on_resize",
           # the port's own
           "opt_state_from_reference"]
