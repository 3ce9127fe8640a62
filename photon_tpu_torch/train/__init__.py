"""Training: the train/eval steps and the single-device Trainer."""

from photon_tpu_torch.train.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
