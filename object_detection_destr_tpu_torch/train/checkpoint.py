"""Checkpoints with working resume (port of
``object_detection_destr_tpu/train/checkpoint.py``, l.43-139), written with
``torch.save`` where the JAX package writes Orbax trees.

A checkpoint is one file, ``checkpoint_dir/name``, holding:

* "model": the model's parameters and buffers (``state_dict``: the BatchNorm
  statistics are buffers here, a separate collection in flax);
* "optimizer": the AdamW moments (in their dtype, with its name and the
  layout), the counts and, with gradient accumulation, the mini-step and
  the accumulated mean gradient, so that a resume in the middle of an
  accumulation goes on as the uninterrupted run;
* "step": the train step count;
* (no generator state: the dropout and augmentation draws of a step are
  pure functions of the seed and the step, see ``DropoutRng`` and
  ``train/driver.py``);
* "loader": the train loader's (epoch, step), so a resume replays the data
  order;
* "best_val": the best validation loss so far.

Saving stages and swaps as the JAX package does: the payload is written to
``name.new`` (through a temporary file renamed when complete), then ``name``
becomes ``name.old``, ``name.new`` becomes ``name`` and ``name.old`` goes. A
crash anywhere in that sequence leaves a complete checkpoint that
:func:`_resolve_ckpt_path` finds (``name``, then ``name.new``, then
``name.old``).

On a data-parallel run rank 0 alone saves, and the other ranks wait for it
at a barrier (``train/driver.py``); a resume restores the same checkpoint on
every rank, so the replicated state stays replicated.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .state import TrainState

__all__ = ["restore_checkpoint", "restore_for_inference", "save_checkpoint"]


def _ckpt_path(checkpoint_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(checkpoint_dir, name))


def _payload(state: TrainState, loader_state: Optional[dict], best_val: Optional[float]) -> dict:
    opt = state.optimizer
    return {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": {"count": opt.count, "notfinite_count": opt.notfinite_count,
                      "layout": opt.layout, "moment_dtype": str(opt.moment_dtype).removeprefix("torch."),
                      "m": {k: v.detach().cpu() for k, v in opt.m.items()},
                      "v": {k: v.detach().cpu() for k, v in opt.v.items()},
                      "accum_steps": opt.accum_steps, "mini_step": opt.mini_step,
                      "acc": None if opt.accumulated is None else opt.accumulated.detach().cpu()},
        "step": int(state.step),
        "loader": dict(loader_state or {}),
        "best_val": float(best_val if best_val is not None else math.inf),
    }


def save_checkpoint(
    checkpoint_dir: str,
    name: str,
    state: TrainState,
    loader_state: Optional[dict] = None,
    best_val: Optional[float] = None,
) -> str:
    """Write {model, optimizer, step, loader, best_val} under
    ``checkpoint_dir/name`` by stage and swap; returns the path."""
    path = _ckpt_path(checkpoint_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    staged = path + ".new"
    partial = f"{staged}.{os.getpid()}.partial"
    torch.save(_payload(state, loader_state, best_val), partial)
    os.replace(partial, staged)  # a complete ``.new`` or none
    if os.path.exists(path):
        old = path + ".old"
        if os.path.exists(old):
            os.remove(old)
        os.rename(path, old)
        os.rename(staged, path)
        os.remove(old)
    else:
        os.rename(staged, path)
    return path


def _resolve_ckpt_path(checkpoint_dir: str, name: str) -> str:
    """Newest complete checkpoint among path / path.new / path.old (between
    the two renames of a swap there is no file at ``path``)."""
    path = _ckpt_path(checkpoint_dir, name)
    for candidate in (path, path + ".new", path + ".old"):
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f"no checkpoint at {path}")


def _load(checkpoint_dir: str, name: str) -> dict:
    return torch.load(_resolve_ckpt_path(checkpoint_dir, name), map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_checkpoint(checkpoint_dir: str, name: str, state: TrainState) -> dict:
    """Restore a checkpoint into ``state`` in place (its model, optimizer and
    step). Returns {"state", "loader", "best_val"};
    raises FileNotFoundError where there is none (the reference silently
    trained from scratch)."""
    raw = _load(checkpoint_dir, name)
    state.model.load_state_dict(raw["model"])
    opt, saved = state.optimizer, raw["optimizer"]
    if set(saved["m"]) != set(opt.m):
        raise ValueError(f"{name}: its optimizer holds other parameters than this run's "
                         "(lr_backbone = 0 freezes the backbone's moments away; the flat layout "
                         "keeps the frozen ones)")
    dtype = next(iter(saved["m"].values())).dtype if saved["m"] else opt.moment_dtype
    if dtype != opt.moment_dtype:
        raise ValueError(f"{name}: moments in {dtype}, this run keeps them in {opt.moment_dtype} "
                         "(--moment_dtype)")
    if int(saved.get("accum_steps", 1)) != opt.accum_steps:
        raise ValueError(f"{name}: written with grad_accum_steps={saved.get('accum_steps', 1)}, "
                         f"this run has {opt.accum_steps}")
    for ours, theirs in ((opt.m, saved["m"]), (opt.v, saved["v"])):
        for key, tensor in ours.items():
            tensor.copy_(theirs[key])
    opt.count, opt.notfinite_count = int(saved["count"]), int(saved["notfinite_count"])
    if opt.accumulated is not None:
        opt.accumulated.copy_(saved["acc"])
        opt.mini_step = int(saved["mini_step"])
    state.step = int(raw["step"])
    return {"state": state, "loader": raw["loader"], "best_val": float(raw["best_val"])}


def restore_for_inference(checkpoint_dir: str, name: str) -> dict[str, torch.Tensor]:
    """Only the model's variables, a ``state_dict`` on the CPU (parameters
    and BatchNorm statistics): inference does not depend on how the
    checkpoint was trained."""
    return _load(checkpoint_dir, name)["model"]
