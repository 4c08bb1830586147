"""Train state (port of ``object_detection_destr_tpu/train/state.py``): the
model (its parameters and BatchNorm statistics), the optimizer, the step
count (on the host), and the dropout stream, drawn from a generator reseeded
from ``TrainConfig.seed`` and the step at each step (SSD has no dropout; its
state carries the stream all the same, which the epoch runner registers)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import TrainConfig
from ..models.destr.layers import DropoutRng
from .optim import AdamW, lr_schedule

__all__ = ["TrainState", "create_destr_state", "create_ssd_state"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
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


def _init_state(model: nn.Module, train_cfg: TrainConfig, steps_per_epoch: int = 0) -> TrainState:
    """Puts ``model`` in training mode with a gradient on every parameter
    (the frozen ones too: the clip and the finite check count them) and
    builds the optimizer (``param_labels`` decides which parameters train;
    ``opt_layout``, ``moment_dtype`` and ``grad_accum_steps`` as
    state.py:95-110 hands them to ``build_optimizer``) and the dropout
    stream (state.py:74-119)."""
    for p in model.parameters():
        p.requires_grad_(True)
    model.train()
    lr, lr_backbone = _lr_specs(train_cfg, steps_per_epoch)
    optimizer = AdamW(
        model, lr=lr, lr_backbone=lr_backbone,
        grad_clip=train_cfg.grad_clip_norm or None,
        skip_nonfinite=train_cfg.skip_nonfinite_updates,
        layout=train_cfg.opt_layout,
        moment_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[train_cfg.moment_dtype],
        accum_steps=train_cfg.grad_accum_steps,
    )
    device = next(model.parameters()).device
    return TrainState(model=model, optimizer=optimizer, rng=DropoutRng(train_cfg.seed, device))


def create_destr_state(model: nn.Module, train_cfg: TrainConfig, steps_per_epoch: int = 0) -> TrainState:
    """The DESTR state (state.py:122-130)."""
    return _init_state(model, train_cfg, steps_per_epoch)


def create_ssd_state(model: nn.Module, train_cfg: TrainConfig, steps_per_epoch: int = 0) -> TrainState:
    """The SSD state (state.py:133-140). ``param_labels`` marks the VGG trunk
    (``backbone.conv*``) "frozen", as the JAX package's rule does for these
    names: it gets gradients, which count in the clip and the finite check,
    and no update."""
    return _init_state(model, train_cfg, steps_per_epoch)
