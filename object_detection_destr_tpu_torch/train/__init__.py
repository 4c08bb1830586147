from .driver import train_destr
from .optim import AdamW, param_labels
from .state import TrainState, create_destr_state
from .steps import make_destr_train_step

__all__ = ["AdamW", "TrainState", "create_destr_state", "make_destr_train_step", "param_labels", "train_destr"]
