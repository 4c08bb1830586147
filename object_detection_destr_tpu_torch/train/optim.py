"""AdamW with the reference's parameter groups, global-norm clipping,
skip-if-non-finite, gradient accumulation, bfloat16 moments and the three
optimizer layouts (port of ``object_detection_destr_tpu/train/optim.py``:
``param_labels`` l.37-57, ``fused_adamw`` l.60-130, ``scale_by_adam_compact``
l.138-199, ``grouped_adamw`` l.226-313, ``build_optimizer`` l.315-387).

The JAX package builds, outermost first,

    optax.MultiSteps(                               # grad_accum_steps
        optax.apply_if_finite(                      # skip_nonfinite
            optax.chain(optax.clip_by_global_norm,  # grad_clip
                        adamw by layout)))

and :class:`AdamW` computes the same update:

* the finite check and the global norm run over the gradients of every
  parameter, "frozen" ones included (the stem, layer1 and all four FrozenBN
  tensors are flax params there; the trainer gives them gradients here);
* clip: ``(g / norm) * max_norm`` only where ``norm >= max_norm`` (no
  epsilon);
* AdamW: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with bias
  correction on the count of applied updates and ``lr`` from the schedule at
  that count before the increment; "frozen" leaves, and "backbone" ones at
  ``lr_backbone == 0``, get no update and no decay;
* a step whose gradients hold inf/NaN changes nothing, unless more than
  ``skip_nonfinite`` such steps came in a row: then, as optax does, the
  update is applied (the driver halts on non-finite parameters).

**Layouts** (``opt_layout``). In the JAX package they differ in how the
update is laid out in TPU memory, not in its arithmetic; here every layout
keeps one flat moment buffer a group. What differs is kept:
"auto" is "per-leaf"; "per-leaf" and "grouped" keep moments for the
trainable leaves only; "flat" keeps float32 moments for every leaf and
updates the frozen ones at lr 0 (``p + -0 * update``: they do not move
unless the update is not finite), ignores ``moment_dtype`` and raises
``ValueError`` on an lr schedule.

**Moments** (``moment_dtype``): "bfloat16" stores both moments in bfloat16,
reads them upcast to float32, computes in float32 in the JAX package's
order (the clip's ``(g / norm) * max_norm``, ``m * b1 + g * (1 - b1)``,
``v * b2 + g * g * (1 - b2)``) and rounds to nearest even on the write, as
``astype`` does, so that they are bit-equal to JAX's; the update uses the
unrounded float32 moments. Float32 moments take the fused forms (``g *
scale``, ``add`` with ``alpha``, ``addcmul``: fewer passes over the group,
a multiply-add rounded once) and agree with JAX's to float32 rounding.

**Accumulation** (``accum_steps`` k > 1, ``optax.MultiSteps`` with its
default running mean): each call folds the gradients into ``acc + (g - acc)
/ (n + 1)`` (n the mini-step, in this operation order), runs the clip, the
finite check and AdamW on the mean, and commits the result on the k-th
mini-step only: before it, the parameters, the moments and the counts stay
as they were. The reset is ``(1 - emit) * acc`` and the parameters move by
``emit * update``, so, as in optax, a non-finite mini-step leaves the
accumulator non-finite for good and each later update is rejected until
``skip_nonfinite`` is exceeded. The lr schedule counts applied updates, not
mini-steps (ROADMAP.md, notes on the JAX package). Over a data-parallel
mesh the step all-reduces the gradients before :meth:`AdamW.step`, so each
mini-step's gradient is already the global batch's, as JAX reduces inside
every step; the accumulator, the mini-step count and the moments stay
replicated across the ranks, in every layout.

Everything a step decides lives on the device, so the host never waits for
it and a CUDA graph can capture the step (``train/epoch_scan.py``): the
count of applied updates, of consecutive non-finite steps and the mini-step
are int64 tensors, the lr schedule and the bias corrections are computed
from the count there, and a skipped step is ``torch.where`` over the moments
and the parameters' step. The moments of a group are one flat buffer (``m``
and ``v`` hold a view a parameter), so that the Adam arithmetic and the
selects are a few kernels a group rather than a few a parameter.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

__all__ = ["AdamW", "LAYOUTS", "param_labels", "lr_schedule"]

_TRAINABLE_BACKBONE_PREFIXES = ("layer2", "layer3", "layer4")
LAYOUTS = ("auto", "per-leaf", "grouped", "flat")

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
    """The optimizer over ``model.named_parameters()``; see the module doc.

    ``layout`` is one of :data:`LAYOUTS`, ``moment_dtype`` a torch dtype
    (float32 or bfloat16), ``accum_steps`` the mini-steps an update
    accumulates (1 = off).
    """

    def __init__(self, model: nn.Module, lr: LrSpec = 1e-5, lr_backbone: LrSpec = 1e-4,
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: Optional[float] = None,
                 skip_nonfinite: int = 0, layout: str = "per-leaf",
                 moment_dtype: torch.dtype = torch.float32, accum_steps: int = 1):
        if layout not in LAYOUTS:
            raise ValueError(f"opt_layout={layout!r}: one of {LAYOUTS}")
        if moment_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"moment_dtype={moment_dtype}: float32 or bfloat16")
        self.layout = "per-leaf" if layout == "auto" else layout
        flat = self.layout == "flat"
        if flat and (callable(lr) or callable(lr_backbone)):
            raise ValueError(
                "the flat layout takes one fixed lr a parameter and cannot take a schedule; "
                "use opt_layout per-leaf or grouped with lr_drop / lr_warmup_steps"
            )
        self.moment_dtype = torch.float32 if flat else moment_dtype  # flat ignores moment_dtype
        self.labels = param_labels(model)
        self.params = dict(model.named_parameters())
        bb_frozen = (not callable(lr_backbone)) and lr_backbone <= 0
        self.lr = {"main": lr, "backbone": 0.0 if bb_frozen else lr_backbone, "frozen": 0.0}
        # the groups that carry moments: flat keeps frozen leaves at lr 0
        kept = ("main", "backbone", "frozen") if flat else ("main",) if bb_frozen else ("main", "backbone")
        self.groups = {g: [n for n, lab in self.labels.items() if lab == g] for g in kept}
        self.groups = {g: names for g, names in self.groups.items() if names}
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.accum_steps = max(int(accum_steps), 1)
        device = next(iter(self.params.values())).device
        self._count = torch.zeros((), dtype=torch.int64, device=device)  # applied updates
        self._notfinite = torch.zeros((), dtype=torch.int64, device=device)  # consecutive non-finite steps
        self._m, self._v, self.m, self.v = {}, {}, {}, {}
        for group, names in self.groups.items():
            for flat_buf, views in ((self._m, self.m), (self._v, self.v)):
                flat_buf[group] = torch.zeros(sum(self.params[n].numel() for n in names),
                                              dtype=self.moment_dtype, device=device)
                views.update(zip(names, self._views(flat_buf[group], names)))
        # the accumulated mean gradient of every parameter and the mini-step
        self._acc: Optional[torch.Tensor] = None
        self._mini = torch.zeros((), dtype=torch.int64, device=device)
        if self.accum_steps > 1:
            self._acc = torch.zeros(sum(p.numel() for p in self.params.values()), dtype=torch.float32,
                                    device=device)

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

    @property
    def mini_step(self) -> int:
        """Mini-steps accumulated towards the next update (read from the device)."""
        return int(self._mini)

    @mini_step.setter
    def mini_step(self, value: int) -> None:
        self._mini.fill_(int(value))

    @property
    def accumulated(self) -> Optional[torch.Tensor]:
        """The running mean of this update's gradients, one flat float32
        buffer in ``named_parameters`` order (None without accumulation)."""
        return self._acc

    def grads(self) -> list[torch.Tensor]:
        """The gradient of every parameter (zeros where none was computed)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params.values()]

    def _lr(self, group: str) -> torch.Tensor | float:
        spec = self.lr[group]
        return spec(self._count) if callable(spec) else float(spec)

    def _accumulate(self, grads: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Fold ``grads`` into the running mean (``MultiSteps``' Welford
        form); returns (the mean, one view a parameter; whether this
        mini-step emits)."""
        g = torch.cat([t.reshape(-1).float() for t in grads])
        self._acc.copy_(self._acc + (g - self._acc) / (self._mini + 1))
        names = list(self.params)
        return self._views(self._acc, names), self._mini == self.accum_steps - 1

    @torch.no_grad()
    def step(self) -> dict:
        """One update (or mini-step) from the parameters' ``.grad``, on the
        device. Returns {"grad_norm", "finite", "applied"}, device tensors."""
        grads = self.grads()
        emit = None  # every step emits without accumulation
        if self._acc is not None:
            grads, emit = self._accumulate(grads)
        norms = torch._foreach_norm(grads)  # per-tensor 2-norms: inf/NaN if any element is
        total = torch.stack([n.float() for n in norms]).square().sum().sqrt()
        finite = torch.isfinite(total)
        apply = None  # every update applies
        if self.skip_nonfinite:
            notfinite = torch.where(finite, 0, self._notfinite + 1)
            self._notfinite.copy_(_select(emit, notfinite, self._notfinite))
            apply = finite | (notfinite > self.skip_nonfinite)
        # the inner state moves only where the update applies, on an emitting mini-step
        commit = emit if apply is None else apply if emit is None else apply & emit
        by_name = dict(zip(self.params, grads))
        count_inc = self._count + 1
        bc1 = 1.0 - torch.pow(self.b1, count_inc)
        bc2 = 1.0 - torch.pow(self.b2, count_inc)
        if self.grad_clip:
            keep = total < self.grad_clip
            scale = torch.where(keep, 1.0, self.grad_clip / total)
        for group, names in self.groups.items():
            params = [self.params[n] for n in names]
            g = torch.cat([by_name[n].reshape(-1).float() for n in names])
            m, v = self._m[group], self._v[group]
            if m.dtype == torch.float32:  # fused forms, fewer passes over the group
                if self.grad_clip:
                    g = g * scale
                m_new = torch.add(m * self.b1, g, alpha=1.0 - self.b1)
                v_new = torch.addcmul(v * self.b2, g, g, value=1.0 - self.b2)
            else:  # JAX's order, so that the moments round to the same bfloat16
                if self.grad_clip:
                    g = torch.where(keep, g, g / total * self.grad_clip)
                m_new = m.float() * self.b1 + g * (1.0 - self.b1)
                v_new = v.float() * self.b2 + g * g * (1.0 - self.b2)
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            m.copy_(_select(commit, m_new.to(m.dtype), m))
            v.copy_(_select(commit, v_new.to(v.dtype), v))
            upd = torch.add(upd, torch.cat([p.reshape(-1).float() for p in params]), alpha=self.weight_decay)
            delta = _select(apply, upd * -self._lr(group), 0.0)  # lr 0 (flat's frozen leaves): -0 * update
            if emit is not None:
                delta = delta * emit  # MultiSteps' emit * update: 0 * NaN stays NaN
            torch._foreach_add_(params, [d.to(p.dtype) for d, p in zip(self._views(delta, names), params)])
        if commit is None:
            self._count.add_(1)
        else:
            self._count.add_(commit.long())
        if emit is not None:
            self._acc.mul_(~emit)  # (1 - emit) * acc: a NaN accumulator stays NaN
            self._mini.copy_((self._mini + 1) % self.accum_steps)
        applied = torch.ones_like(finite) if commit is None else commit
        return {"grad_norm": total, "finite": finite, "applied": applied}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
