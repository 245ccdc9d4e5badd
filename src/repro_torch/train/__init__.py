"""Training: the optimizer, the step builders and the fault-tolerant loop."""
from repro_torch.train.optim import (OptConfig, adamw_update, init_opt_state,
                                     lr_at_step)
from repro_torch.train.step import build_eval_step, build_train_step

__all__ = ["OptConfig", "adamw_update", "build_eval_step",
           "build_train_step", "init_opt_state", "lr_at_step"]
