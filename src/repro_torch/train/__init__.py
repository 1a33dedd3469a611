"""Training of the port: 8-bit AdamW, the train step and gradient
quantization (port of ``repro/train``)."""
from . import compress_grads
from .optimizer import (AdamWConfig, Q8, apply_updates, init_state,
                        lr_schedule)
from .train_step import make_eval_step, make_loss_fn, make_train_step

__all__ = ["AdamWConfig", "Q8", "init_state", "apply_updates",
           "lr_schedule", "make_train_step", "make_eval_step",
           "make_loss_fn", "compress_grads"]
