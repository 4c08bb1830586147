"""Seeded weights of a DESTR, made on its device in one draw: every matrix
and kernel (a leaf of two or more dimensions) from one ``torch.randn`` of a
generator on the device seeded from the seed, scaled by ``1 / sqrt(fan
in)``; LayerNorm and BatchNorm scales and variances 1, biases and means 0
(the FrozenBN tensors then the identity). The leaves are taken in
``named_parameters`` order, then the buffers, so two models of one
architecture get the same values whatever code implements them."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["seeded_weights"]


@torch.no_grad()
def seeded_weights(model: nn.Module, seed: int) -> None:
    leaves = list(model.named_parameters()) + list(model.named_buffers())
    drawn = [t for _, t in leaves if t.dim() >= 2 and t.is_floating_point()]
    device = drawn[0].device
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    noise = torch.randn(sum(t.numel() for t in drawn), generator=gen, device=device, dtype=torch.float32)
    at = 0
    for name, t in leaves:
        if not t.is_floating_point():
            continue
        if t.dim() >= 2:
            fan_in = t[0].numel()
            t.copy_(noise[at:at + t.numel()].view_as(t) * fan_in ** -0.5)
            at += t.numel()
        elif name.rsplit(".", 1)[-1] in ("weight", "running_var"):
            t.fill_(1.0)
        else:
            t.zero_()
