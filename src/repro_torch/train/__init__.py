"""Training (port of :mod:`repro.train`): AdamW, checkpoints, the agile-CNN
network trainer and the LM train step."""
from .optimizer import AdamWState, adamw_init, adamw_update  # noqa: F401
from .trainer import (train_agile_cnn, train_step_lm,  # noqa: F401
                      make_train_step)
from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
