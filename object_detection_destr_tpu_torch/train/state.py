"""Train state (port of ``object_detection_destr_tpu/train/state.py``): the
model (its parameters and BatchNorm statistics), the optimizer, the step
count (on the host), and the dropout stream, drawn from a generator reseeded
from ``TrainConfig.seed`` and the step at each step."""

from __future__ import annotations

import dataclasses

from ..config import TrainConfig
from ..models.destr.layers import DropoutRng
from ..models.destr.model import DESTR
from .optim import AdamW, lr_schedule

__all__ = ["TrainState", "create_destr_state"]


@dataclasses.dataclass
class TrainState:
    model: DESTR
    optimizer: AdamW
    rng: DropoutRng
    step: int = 0


def _lr_specs(train_cfg: TrainConfig, steps_per_epoch: int):
    """(lr, lr_backbone) as floats or schedules on the update count; the
    ``lr_drop`` boundary is ``lr_drop`` epochs in steps (state.py:41-71)."""
    drop = train_cfg.lr_drop * steps_per_epoch if train_cfg.lr_drop > 0 and steps_per_epoch > 0 else 0
    make = lambda base: lr_schedule(base, train_cfg.lr_warmup_steps, drop, train_cfg.lr_drop_factor)
    lr_bb = make(train_cfg.lr_backbone) if train_cfg.lr_backbone > 0 else train_cfg.lr_backbone
    return make(train_cfg.lr), lr_bb


def create_destr_state(model: DESTR, train_cfg: TrainConfig, steps_per_epoch: int = 0) -> TrainState:
    """Puts ``model`` in training mode with a gradient on every parameter
    (the frozen ones too: the clip and the finite check count them) and
    builds the optimizer and the dropout stream."""
    for p in model.parameters():
        p.requires_grad_(True)
    model.train()
    lr, lr_backbone = _lr_specs(train_cfg, steps_per_epoch)
    optimizer = AdamW(
        model, lr=lr, lr_backbone=lr_backbone,
        grad_clip=train_cfg.grad_clip_norm or None,
        skip_nonfinite=train_cfg.skip_nonfinite_updates,
    )
    device = next(model.parameters()).device
    return TrainState(model=model, optimizer=optimizer, rng=DropoutRng(train_cfg.seed, device))
