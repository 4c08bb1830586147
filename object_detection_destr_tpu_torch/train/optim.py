"""AdamW with the reference's parameter groups, global-norm clipping and
skip-if-non-finite (port of ``object_detection_destr_tpu/train/optim.py``,
the per-leaf ``build_optimizer`` layout, l.37-57 and l.455-527).

The JAX package builds, outermost first,

    optax.apply_if_finite(                      # skip_nonfinite
        optax.chain(optax.clip_by_global_norm,  # grad_clip
                    optax.multi_transform({"main": adamw(lr),
                                           "backbone": adamw(lr_backbone) | zero,
                                           "frozen": zero}, labels)))

and :class:`AdamW` computes the same update:

* the finite check and the global norm run over the gradients of every
  parameter, "frozen" ones included (the stem, layer1 and all four FrozenBN
  tensors are flax params there; the trainer gives them gradients here);
* clip: ``g * max_norm / norm`` only where ``norm >= max_norm`` (no epsilon);
* AdamW: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with bias
  correction on the count of applied updates and ``lr`` from the schedule at
  that count before the increment; "frozen" leaves, and "backbone" ones at
  ``lr_backbone == 0``, get no update and no decay;
* a step whose gradients hold inf/NaN changes nothing, unless more than
  ``skip_nonfinite`` such steps came in a row: then, as optax does, the
  update is applied (the driver halts on non-finite parameters).

Only the per-leaf layout and float32 moments are ported; ``opt_layout`` and
``moment_dtype`` other than their defaults raise in the driver.

Everything a step decides lives on the device, so the host never waits for
it and a CUDA graph can capture the step (``train/epoch_scan.py``): the count
of applied updates and of consecutive non-finite steps are int64 tensors, the
lr schedule and the bias corrections are computed from the count there, and
a skipped step is ``torch.where`` over the moments and the parameters' step.
The moments of a group are one flat float32 buffer (``m`` and ``v`` hold a
view a parameter), so that the Adam arithmetic and the selects are a few
kernels a group rather than a few a parameter.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

__all__ = ["AdamW", "param_labels", "lr_schedule"]

_TRAINABLE_BACKBONE_PREFIXES = ("layer2", "layer3", "layer4")

# a float, or a schedule from the update count (an int64 tensor) to the lr
LrSpec = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def param_labels(model: nn.Module) -> dict[str, str]:
    """'main' | 'backbone' | 'frozen' per parameter name (optim.py:177-197)."""
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if "backbone" in parts:
            sub = parts[parts.index("backbone") + 1:]
            if any(p.startswith("bn") or p == "downsample_bn" for p in sub):
                labels[name] = "frozen"  # FrozenBN tensors never train
            elif sub and any(sub[0].startswith(pref) for pref in _TRAINABLE_BACKBONE_PREFIXES):
                labels[name] = "backbone"
            else:  # stem conv, layer1
                labels[name] = "frozen"
        else:
            labels[name] = "main"
    return labels


def lr_schedule(base: float, warmup_steps: int = 0, drop_step: int = 0,
                drop_factor: float = 0.1) -> LrSpec:
    """The JAX package's schedule on the update count (state.py:41-71):
    ``base * (factor if count >= drop_step) * min(1, (count + 1) / warmup)``
    in float32 on the count's device; a plain float when neither is set."""
    if not (warmup_steps or drop_step):
        return base

    def sched(count: torch.Tensor) -> torch.Tensor:
        value = torch.full((), base, dtype=torch.float32, device=count.device)
        if drop_step:
            value = value * torch.where(count >= drop_step, drop_factor, 1.0)
        if warmup_steps:
            value = value * torch.clamp((count + 1) / warmup_steps, max=1.0)
        return value

    return sched


def _select(apply: Optional[torch.Tensor], new: torch.Tensor, old) -> torch.Tensor:
    """``new`` where the update applies (always when ``apply`` is None)."""
    return new if apply is None else torch.where(apply, new, old)


class AdamW:
    """The optimizer over ``model.named_parameters()``; see the module doc."""

    def __init__(self, model: nn.Module, lr: LrSpec = 1e-5, lr_backbone: LrSpec = 1e-4,
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: Optional[float] = None,
                 skip_nonfinite: int = 0):
        self.labels = param_labels(model)
        self.params = dict(model.named_parameters())
        bb_frozen = (not callable(lr_backbone)) and lr_backbone <= 0
        self.lr = {"main": lr, "backbone": lr_backbone}
        self.groups = {
            g: [n for n, lab in self.labels.items() if lab == g]
            for g in ("main", "backbone") if not (g == "backbone" and bb_frozen)
        }
        self.groups = {g: names for g, names in self.groups.items() if names}
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        device = next(iter(self.params.values())).device
        self._count = torch.zeros((), dtype=torch.int64, device=device)  # applied updates
        self._notfinite = torch.zeros((), dtype=torch.int64, device=device)  # consecutive non-finite steps
        self._m, self._v, self.m, self.v = {}, {}, {}, {}
        for group, names in self.groups.items():
            for flat, views in ((self._m, self.m), (self._v, self.v)):
                flat[group] = torch.zeros(sum(self.params[n].numel() for n in names), dtype=torch.float32,
                                          device=device)
                views.update(zip(names, self._views(flat[group], names)))

    def _views(self, flat: torch.Tensor, names: list[str]) -> list[torch.Tensor]:
        """``flat`` split into one view a parameter, each of its shape."""
        sizes = [self.params[n].numel() for n in names]
        return [part.view(self.params[n].shape) for part, n in zip(torch.split(flat, sizes), names)]

    @property
    def count(self) -> int:
        """Applied updates (read from the device)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))

    @property
    def notfinite_count(self) -> int:
        """Consecutive non-finite steps (read from the device)."""
        return int(self._notfinite)

    @notfinite_count.setter
    def notfinite_count(self, value: int) -> None:
        self._notfinite.fill_(int(value))

    def grads(self) -> list[torch.Tensor]:
        """The gradient of every parameter (zeros where none was computed)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params.values()]

    def _lr(self, group: str) -> torch.Tensor | float:
        spec = self.lr[group]
        return spec(self._count) if callable(spec) else float(spec)

    @torch.no_grad()
    def step(self) -> dict:
        """One update from the parameters' ``.grad``, on the device. Returns
        {"grad_norm", "finite", "applied"}, device tensors."""
        grads = self.grads()
        norms = torch._foreach_norm(grads)  # per-tensor 2-norms: inf/NaN if any element is
        total = torch.stack([n.float() for n in norms]).square().sum().sqrt()
        finite = torch.isfinite(total)
        apply = None  # every update applies
        if self.skip_nonfinite:
            notfinite = torch.where(finite, 0, self._notfinite + 1)
            self._notfinite.copy_(notfinite)
            apply = finite | (notfinite > self.skip_nonfinite)
        by_name = dict(zip(self.params, grads))
        count_inc = self._count + 1
        bc1 = 1.0 - torch.pow(self.b1, count_inc)
        bc2 = 1.0 - torch.pow(self.b2, count_inc)
        if self.grad_clip:
            clip = torch.where(total < self.grad_clip, 1.0, self.grad_clip / total)
        for group, names in self.groups.items():
            params = [self.params[n] for n in names]
            g = torch.cat([by_name[n].reshape(-1).float() for n in names])
            if self.grad_clip:
                g = g * clip
            m, v = self._m[group], self._v[group]
            m_new = torch.add(m * self.b1, g, alpha=1.0 - self.b1)
            v_new = torch.addcmul(v * self.b2, g, g, value=1.0 - self.b2)
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            upd = torch.add(upd, torch.cat([p.reshape(-1).float() for p in params]), alpha=self.weight_decay)
            delta = _select(apply, upd * -self._lr(group), 0.0)
            m.copy_(_select(apply, m_new, m))
            v.copy_(_select(apply, v_new, v))
            torch._foreach_add_(params, [d.to(p.dtype) for d, p in zip(self._views(delta, names), params)])
        self._count.add_(1 if apply is None else apply.long())
        return {"grad_norm": total, "finite": finite, "applied": torch.ones_like(finite) if apply is None else apply}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
