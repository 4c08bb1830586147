"""Head-packed masked attention with the flash kernels' Philox dropout, in
plain PyTorch (a frozen copy of the plain versions in
``object_detection_destr_tpu_torch/ops/cuda/flash_attention.py`` l.136-141,
336-454).

Element (b, head, q, k) is kept iff word 0 of Philox4x32-10 with key (seed,
0) and counter (q, k, b*h + head, 0) is ``>= uint32(rate * 2**32)``; kept
probabilities are scaled by ``1 / (1 - rate)`` and rounded to the operands'
dtype before P V, as the kernels round them. Differentiable through
autograd. The keep mask is drawn in blocks of query rows, so a 7056 x 7056
site fits beside the rest of a step.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def _autocast(device_type: str, **kwargs):
    """``torch.autocast``, and nothing on the meta device."""
    return contextlib.nullcontext() if device_type == "meta" else torch.autocast(device_type, **kwargs)


__all__ = ["packed_attention", "philox_keep_bits", "keep_mask", "attention_sites"]

NEG_INF = -1e9
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_ROWS = 256  # query rows a block of the keep mask draws

Seed = Union[int, torch.Tensor]

# every call's shape, where a caller collects them (attention_sites)
_SITES: Optional[list] = None
# where set (steps.lower_precision), a rounding of the products' operands
OPERAND_ROUNDING = None


def dropout_threshold(rate: float) -> int:
    return min(max(int(rate * 4294967296.0), 0), 4294967295)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = mh * xl + ml * xh
    lo_full = ml * xl + ((mid & 0xFFFF) << 16)
    hi = mh * xh + (mid >> 16) + (lo_full >> 32)
    return hi & _MASK32, lo_full & _MASK32


def _seed_key(seed: Seed):
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _MASK32
    return int(seed) & _MASK32


def philox_keep_bits(seed: Seed, bh: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10, key (seed, 0), counter (q, k, bh, 0)."""
    c0, c1, c2 = (t.to(torch.int64) for t in (q, k, bh))
    c3 = torch.zeros((), dtype=torch.int64, device=c0.device)
    k0, k1 = _seed_key(seed), 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


@torch.no_grad()
def keep_mask(seed: Seed, rate: float, b: int, h: int, sq: int, sk: int, device) -> torch.Tensor:
    """(B, h, Sq, Sk) bool keep mask, drawn ``_ROWS`` query rows at a time."""
    out = torch.empty((b, h, sq, sk), dtype=torch.bool, device=device)
    bh = torch.arange(b * h, device=device).view(b, h, 1, 1)
    k = torch.arange(sk, device=device).view(1, 1, 1, sk)
    threshold = dropout_threshold(rate)
    for lo in range(0, sq, _ROWS):
        q = torch.arange(lo, min(lo + _ROWS, sq), device=device).view(1, 1, -1, 1)
        out[:, :, lo:lo + q.shape[2]] = philox_keep_bits(seed, bh, q, k) >= threshold
    return out


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, hd = x.shape
    return x.float().reshape(b, s, h, hd // h).transpose(1, 2)


def packed_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, num_heads: int,
                     key_valid_mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                     dropout_seed: Optional[Seed] = None) -> torch.Tensor:
    """query (B, Sq, h*d), key (B, Sk, h*d), value (B, Sk, h*dv) -> (B, Sq,
    h*dv) in the query's dtype; scale 1/sqrt(d), masked keys at -1e9."""
    b, sq, hd = query.shape
    sk, hdv = key.shape[1], value.shape[-1]
    h = num_heads
    if _SITES is not None:
        _SITES.append({"b": b, "sq": sq, "sk": sk, "h": h, "d": hd // h, "dv": hdv // h,
                       "masked": key_valid_mask is not None, "itemsize": query.element_size()})
    scale = 1.0 / float(hd // h) ** 0.5
    with _autocast(query.device.type, enabled=False):
        q, k, v = _heads(query, h), _heads(key, h), _heads(value, h)
        if OPERAND_ROUNDING is not None:
            q, k, v = OPERAND_ROUNDING(q), OPERAND_ROUNDING(k), OPERAND_ROUNDING(v)
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        if key_valid_mask is not None:
            logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        if dropout_rate > 0.0 and dropout_seed is not None:
            keep = keep_mask(dropout_seed, dropout_rate, b, h, sq, sk, query.device)
            probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
        probs = probs.to(query.dtype).float()
        if OPERAND_ROUNDING is not None:
            probs = OPERAND_ROUNDING(probs)
        out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(b, sq, hdv).to(query.dtype)


class attention_sites:
    """``with attention_sites() as sites:`` collects the shape of every
    :func:`packed_attention` call inside the block (the roofline's work)."""

    def __enter__(self) -> list:
        global _SITES
        self._outer, _SITES = _SITES, []
        return _SITES

    def __exit__(self, *exc) -> None:
        global _SITES
        _SITES = self._outer
