"""Training, ported: Eq.(2) losses, Adam and SGD, the SplitNN epoch
engine, on one device or a mesh (``repro_torch.train.vfl``), and the LM
train/eval steps (``repro_torch.train.steps``)."""
from repro_torch.train.losses import (weighted_binary_xent, weighted_mse,
                                      weighted_softmax_xent)
from repro_torch.train.optimizer import (AdamState, adam_init, adam_update,
                                         sgd_init, sgd_update)
from repro_torch.train.steps import (init_train_state, lm_loss,
                                     make_eval_step, make_train_step)

__all__ = [
    "AdamState", "adam_init", "adam_update", "sgd_init", "sgd_update",
    "weighted_softmax_xent", "weighted_mse", "weighted_binary_xent",
    "lm_loss", "make_train_step", "make_eval_step", "init_train_state",
]
