"""AdamW as the training step applies it, one leaf at a time (the
arithmetic of ``object_detection_destr_tpu_torch/train/optim.py::AdamW``
l.130-290 and ``lr_schedule`` l.106-122 with the per-leaf layout and float32
moments): the global norm over every leaf's gradient, frozen ones
included; the clip ``g * max_norm / norm`` where the norm reaches
``max_norm``; ``m``, ``v`` with bias correction on the update count;
``p -= lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd * p)``; the lr linear
over the warm-up and times ``drop_factor`` from ``drop_step``. Leaves are
labelled as ``param_labels`` (l.88-103) labels them: FrozenBN tensors, the
stem and layer1 are frozen, the rest of the backbone trains at
``lr_backbone``. A step whose gradients are not finite changes nothing."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["AdamW", "param_labels"]


def param_labels(model: nn.Module) -> dict[str, str]:
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if "backbone" in parts:
            sub = parts[parts.index("backbone") + 1:]
            if any(p.startswith("bn") or p == "downsample_bn" for p in sub):
                labels[name] = "frozen"
            elif sub and any(sub[0].startswith(pref) for pref in ("layer2", "layer3", "layer4")):
                labels[name] = "backbone"
            else:
                labels[name] = "frozen"
        else:
            labels[name] = "main"
    return labels


class AdamW:
    def __init__(self, model: nn.Module, lr: float, lr_backbone: float, warmup_steps: int = 0,
                 drop_step: int = 0, drop_factor: float = 0.1, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, grad_clip: float = 0.0):
        self.params = dict(model.named_parameters())
        self.labels = param_labels(model)
        self.base = {"main": lr, "backbone": lr_backbone, "frozen": 0.0}
        self.warmup, self.drop_step, self.drop_factor = warmup_steps, drop_step, drop_factor
        self.wd, self.b1, self.b2, self.eps, self.grad_clip = weight_decay, b1, b2, eps, grad_clip
        self.count = 0
        self.m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()
                  if self.labels[n] != "frozen" and not (self.labels[n] == "backbone" and lr_backbone <= 0)}
        self.v = {n: torch.zeros_like(m) for n, m in self.m.items()}

    def lr(self, group: str) -> float:
        value = self.base[group]
        if self.drop_step and self.count >= self.drop_step:
            value *= self.drop_factor
        if self.warmup:
            value *= min((self.count + 1) / self.warmup, 1.0)
        return value

    @torch.no_grad()
    def step(self) -> dict:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float() for n, p in self.params.items()}
        total = torch.stack([g.norm() for g in grads.values()]).square().sum().sqrt()
        if not bool(torch.isfinite(total)):
            return {"grad_norm": total, "applied": False}
        scale = 1.0 if not self.grad_clip or float(total) < self.grad_clip else self.grad_clip / total
        bc1 = 1.0 - self.b1 ** (self.count + 1)
        bc2 = 1.0 - self.b2 ** (self.count + 1)
        for n, m in self.m.items():
            p, g = self.params[n], grads[n] * scale
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / bc1) / (torch.sqrt(self.v[n] / bc2) + self.eps) + self.wd * p.float()
            p.add_((-self.lr(self.labels[n]) * upd).to(p.dtype))
        self.count += 1
        return {"grad_norm": total, "applied": True}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
