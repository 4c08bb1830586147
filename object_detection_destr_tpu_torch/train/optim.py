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
``moment_dtype`` other than their defaults raise in the driver. The finite
check is read on the host, one synchronization a step.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

__all__ = ["AdamW", "param_labels", "lr_schedule"]

_TRAINABLE_BACKBONE_PREFIXES = ("layer2", "layer3", "layer4")

LrSpec = Union[float, Callable[[int], float]]


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
    ``base * (factor if count >= drop_step) * min(1, (count + 1) / warmup)``;
    a plain float when neither is set."""
    if not (warmup_steps or drop_step):
        return base

    def sched(count: int) -> float:
        value = base
        if drop_step:
            value = value * (drop_factor if count >= drop_step else 1.0)
        if warmup_steps:
            value = value * min(1.0, (count + 1) / warmup_steps)
        return value

    return sched


def _lr_at(spec: LrSpec, count: int) -> float:
    return float(spec(count)) if callable(spec) else float(spec)


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
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.count = 0  # applied updates
        self.notfinite_count = 0  # consecutive non-finite steps
        self.m = {n: torch.zeros_like(p, dtype=torch.float32) for g in self.groups.values()
                  for n in g for p in [self.params[n]]}
        self.v = {n: torch.zeros_like(t) for n, t in self.m.items()}

    def grads(self) -> list[torch.Tensor]:
        """The gradient of every parameter (zeros where none was computed)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params.values()]

    @torch.no_grad()
    def step(self) -> dict:
        """One update from the parameters' ``.grad``. Returns
        {"grad_norm": tensor, "finite": bool, "applied": bool}."""
        grads = self.grads()
        norms = torch._foreach_norm(grads)  # per-tensor 2-norms: inf/NaN if any element is
        total = torch.stack([n.float() for n in norms]).square().sum().sqrt()
        finite = True
        if self.skip_nonfinite:
            finite = bool(torch.isfinite(total))
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= self.skip_nonfinite:
                return {"grad_norm": total, "finite": False, "applied": False}
        by_name = dict(zip(self.params, grads))
        if self.grad_clip:
            clip = torch.where(total < self.grad_clip, 1.0, self.grad_clip / total)
        count_inc = self.count + 1
        bc1 = 1.0 - self.b1**count_inc
        bc2 = 1.0 - self.b2**count_inc
        for group, names in self.groups.items():
            if not names:
                continue
            params = [self.params[n] for n in names]
            g = [by_name[n].float() for n in names]
            if self.grad_clip:
                g = torch._foreach_mul(g, clip)
            ms, vs = [self.m[n] for n in names], [self.v[n] for n in names]
            torch._foreach_mul_(ms, self.b1)
            torch._foreach_add_(ms, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(vs, self.b2)
            torch._foreach_addcmul_(vs, g, g, value=1.0 - self.b2)
            denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(torch._foreach_div(ms, bc1), denom)
            torch._foreach_add_(upd, [p.float() for p in params], alpha=self.weight_decay)
            lr = _lr_at(self.lr[group], self.count)
            torch._foreach_add_(params, [u.to(p.dtype) for u, p in zip(upd, params)], alpha=-lr)
        self.count = count_inc
        return {"grad_norm": total, "finite": finite, "applied": True}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
