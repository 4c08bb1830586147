"""Flash attention with attention-probability dropout: the hand-written
CUDA kernels ``csrc/flash_attention_fwd.cu`` (forward),
``csrc/flash_attention_bwd.cu`` (fused backward) and
``csrc/flash_attention_bwd_two_pass.cu`` (two-pass backward: dQ, then dK /
dV), their ctypes bindings, their plain PyTorch versions, and the
``torch.autograd.Function`` s that join them, for two layouts of the
operands.

Port of ``object_detection_destr_tpu/ops/pallas/flash_attention.py``:

* head-packed ``(B, S, h*d)``, ``flash_attention_packed`` (l.1174): the
  forward ``_fwd_kernel_packed`` (l.592, kernel #1), the fused backward
  ``_dkvq_kernel_packed`` (l.884, #2) and the two-pass backward
  ``_dq_kernel_packed`` (l.778, #3) / ``_dkv_kernel_packed`` (l.826, #4)
  behind its custom VJP;
* head-major ``(B, h, S, d)``, ``flash_attention`` (l.307, forward only) and
  ``flash_attention_trainable`` (l.531): the forward ``_fwd_kernel`` (l.151,
  #5) and the two-pass backward ``_dq_kernel`` (l.344, #6) /
  ``_dkv_kernel`` (l.385, #7). The CUDA kernels take each operand's (batch,
  head, row) strides, so #5 is the forward kernel and #6 / #7 the two-pass
  kernels launched with head-major strides, each through a wrapper of its
  own with its own launch count. The head-major backward is always two-pass,
  as ``_bwd_impl`` (l.438) is.

Choice of backward (:func:`backward_plan`, the rule of ``_bwd_impl_packed``
l.1037-1041 on this card's terms): the fused kernel keeps a 32-key tile's
float32 dK / dV accumulators in shared memory, so it runs where that layout
fits the device's opt-in shared memory per block and its widest head
dispatches (≤ 512); the two-pass kernels otherwise. On an H100 (227 KB a
block) a hidden-512 DESTR runs the fused kernel for encoder (d 64) and
decoder (d 128) self-attention and the two-pass kernels for the merged
cross-attention (d 1024, dv 512). The TPU's rule is a VMEM budget per key
chunk (``_pick_chunk_nk``); there the decoder self-attention of the same
model also takes the two-pass kernels. The function is the same either way.

Dropout: element (b, head, q, k) is kept iff its Philox4x32-10 bits (key
(seed, 0), counter (q, k, b*h + head, 0); ``csrc/philox.cuh``) are
``>= uint32(rate * 2**32)``, the rule of ``_drop_threshold`` (l.102-105), and
kept probabilities are scaled by ``1 / (1 - rate)``. The seed is an int or a
one-element int64 tensor (its low 32 bits); the kernels read it from device
memory, as the Pallas kernels read theirs from a ref (``_prng_keep`` l.108),
so a CUDA graph that replays a launch draws the mask of whatever seed the
tensor holds at the replay. An int is written to a fresh device tensor. The logsumexp is that of
the undropped probabilities. The TPU's own PRNG bits are not reproduced; the
plain version draws the same Philox bits as the kernels, or takes an explicit
``(B, h, Sq, Sk)`` keep mask (the CPU tests feed it the JAX package's
``dropout_keep_mask``). The counter holds ``b*h + head`` in both layouts, so
one logical input draws one keep mask whichever layout carries it.

A fully masked row (every key masked) averages over the Sk real keys in
every kernel and plain version here, as ``ops/attention.py`` does. The
Pallas kernels average over the keys padded up to their 128-key tile as well
(ROADMAP.md, notes on the JAX package); no model input has such a row.

A CUDA tensor launches the kernels or raises; a CPU tensor runs the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from ..attention import NEG_INF
from .build import CudaLibrary, LaunchCounter

__all__ = [
    "FlashAttentionBackward",
    "FlashAttentionForward",
    "FlashAttentionTwoPass",
    "backward_plan",
    "dropout_threshold",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_backward_reference",
    "flash_attention_packed_reference",
    "flash_attention_reference",
    "flash_attention_trainable",
    "flash_attention_unpacked_dkv",
    "flash_attention_unpacked_dkv_reference",
    "flash_attention_unpacked_dq",
    "flash_attention_unpacked_dq_reference",
    "flash_attention_unpacked_fwd",
    "fused_backward_smem_bytes",
    "philox_keep_bits",
    "seed_tensor",
]

_MAX_HEAD_DIM = 1024  # kernels #1, #3, #4; #2 is bounded by backward_plan
_FUSED_MAX_HEAD_DIM = 512  # the widest head the fused backward dispatches
# the fused backward's tiles (csrc/flash_common.cuh, flash_attention_bwd.cu):
# float32, and the keys a block of the bfloat16 tensor-core kernel
_TILE_K, _BWD_ROWS, _HEADER_BYTES = 32, 8, 32 * 4
_TC_KEYS = 32
_FULLY_MASKED_LSE = -5e8  # below any row with a valid key; the kernels use the same bound
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# a dropout seed: an int, or a one-element int64 tensor (its low 32 bits)
Seed = Union[int, torch.Tensor]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
FWD_LIBRARY = CudaLibrary(
    "odtt_flash_attention_fwd", "flash_attention_fwd.cu",
    headers=("flash_common.cuh", "philox.cuh", "tensor_core.cuh"),
    functions={"odtt_flash_attention_fwd": (_I, [_P] * 7 + [_I] * 7 + [_F, _P, _U, _F, _P])},
    abi=("odtt_flash_fwd_abi_version", 6),
)
BWD_LIBRARY = CudaLibrary(
    "odtt_flash_attention_bwd", "flash_attention_bwd.cu",
    headers=("flash_common.cuh", "philox.cuh", "tensor_core.cuh"),
    functions={"odtt_flash_attention_bwd": (_I, [_P] * 10 + [_I] * 7 + [_F, _P, _U, _F, _P]),
               "odtt_flash_bwd_smem_bytes": (ctypes.c_longlong, [_I] * 3)},
    abi=("odtt_flash_bwd_abi_version", 4),
)
TWO_PASS_LIBRARY = CudaLibrary(
    "odtt_flash_attention_bwd_two_pass", "flash_attention_bwd_two_pass.cu",
    headers=("flash_common.cuh", "philox.cuh", "tensor_core.cuh"),
    functions={"odtt_flash_attention_two_pass": (_I, [_I] + [_P] * 11 + [_I] * 7 + [_F, _P, _U, _F, _P])},
    abi=("odtt_flash_bwd_two_pass_abi_version", 3),
)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _tc_backward_smem_bytes(d: int, dv: int) -> int:
    """``TcLayout`` of the bfloat16 tensor-core kernel: the key states, lse
    and delta of 1 or 2 query tiles, the K and V rows of 32 keys, 1 or 2 q /
    dO tiles, the hi / lo bf16 tiles of P keep and dS, and, where the dK / dV
    accumulators do not fit in registers (``TcPlan``), those in float32."""
    cw = 32 if max(d, dv) <= 32 else 64
    jobs = 2 * (_round_up(d, cw) + _round_up(dv, cw)) // cw  # (16 keys, cw columns) of dK and dV
    jpw = -(-jobs // 4) if jobs <= 8 else 0
    if not jpw:
        cw = 64
    stages, qt = (2, 64) if jpw else (1, 32)
    ks, vs, ps = _round_up(d, 16) + 8, _round_up(dv, 16) + 8, qt + 8
    total = _TC_KEYS * 4 + 2 * 4 * stages * qt  # key states, lse, delta
    total += 2 * _TC_KEYS * (ks + vs) + 2 * stages * qt * (ks + vs) + 4 * 2 * _TC_KEYS * ps
    if not jpw:
        total += 4 * _TC_KEYS * (_round_up(d, cw) + 8 + _round_up(dv, cw) + 8)
    return total


def fused_backward_smem_bytes(d: int, dv: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the fused backward (#2) at head
    widths d, dv: the ``Layout`` (float32, itemsize 4) or ``TcLayout``
    (bfloat16, itemsize 2) of ``csrc/flash_attention_bwd.cu``, which the
    library exports as ``odtt_flash_bwd_smem_bytes``."""
    if itemsize == 2:
        return _tc_backward_smem_bytes(d, dv)
    q = _HEADER_BYTES + 2 * 4 * _BWD_ROWS * _TILE_K  # after the ds and pd rows
    dk = q + 4 * _BWD_ROWS * (d + dv)  # after the staged q and dO rows
    k_tile = _round16(dk + 4 * _TILE_K * (d + dv))  # after the dK, dV accumulators
    v_tile = _round16(k_tile + itemsize * _TILE_K * d)
    return v_tile + itemsize * _TILE_K * dv


def backward_plan(d: int, dv: int, dtype: torch.dtype, smem_limit: Optional[int] = None) -> str:
    """"fused" (kernel #2) where its widest head dispatches and, given a
    device's opt-in shared memory per block ``smem_limit``, its layout fits;
    "two_pass" (kernels #3, #4) otherwise. ``smem_limit=None`` (the plain
    versions on the CPU) checks the width only."""
    if max(d, dv) > _FUSED_MAX_HEAD_DIM:
        return "two_pass"
    itemsize = torch.empty((), dtype=dtype).element_size()
    if smem_limit is not None and fused_backward_smem_bytes(d, dv, itemsize) > smem_limit:
        return "two_pass"
    return "fused"


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this; P(drop) = threshold / 2**32 (l.102-105)."""
    return min(max(int(rate * 4294967296.0), 0), 4294967295)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for 32-bit m and x held in int64, from
    16-bit partial products so nothing overflows int64."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = mh * xl + ml * xh
    lo_full = ml * xl + ((mid & 0xFFFF) << 16)
    hi = mh * xh + (mid >> 16) + (lo_full >> 32)
    return hi & _MASK32, lo_full & _MASK32


def _seed_key(seed) -> "int | torch.Tensor":
    """The low 32 bits of a seed given as an int or a one-element tensor (a
    0-d int64 tensor then, on the seed's device; nothing is read to the
    host)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _MASK32
    return int(seed) & _MASK32


def philox_keep_bits(seed, bh: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 with key (seed, 0) and counter (q, k, bh, 0),
    as int64 in [0, 2**32); the three coordinate tensors broadcast, ``seed``
    is an int or a one-element int64 tensor. The same bits
    ``csrc/philox.cuh`` draws in the kernels."""
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


def _keep_mask(seed, rate: float, b: int, h: int, sq: int, sk: int, device) -> torch.Tensor:
    """(B, h, Sq, Sk) bool keep mask of the kernels' Philox rule."""
    bh = torch.arange(b * h, device=device).view(b, h, 1, 1)
    q = torch.arange(sq, device=device).view(1, 1, sq, 1)
    k = torch.arange(sk, device=device).view(1, 1, 1, sk)
    return philox_keep_bits(seed, bh, q, k) >= dropout_threshold(rate)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, hd = x.shape
    return x.float().reshape(b, s, h, hd // h).transpose(1, 2)


def _dropout_keep(rate, seed, keep_mask, b, h, sq, sk, device) -> Optional[torch.Tensor]:
    if rate <= 0.0:
        return None
    if keep_mask is not None:
        return keep_mask.to(device=device, dtype=torch.bool)
    if seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed or a keep_mask")
    return _keep_mask(seed, rate, b, h, sq, sk, device)


def _scale_of(scale: Optional[float], d: int) -> float:
    return 1.0 / d**0.5 if scale is None else scale


def _attention(q, k, v, key_valid_mask, scale, dropout_rate, dropout_seed, keep_mask, dtype):
    """The forward on head-major float32 (B, h, S, d) operands: out (B, h, Sq,
    dv) float32 and lse (B, h, Sq). P keep / (1 - rate) is rounded to the
    operands' ``dtype`` before P V, where ``_fwd_kernel_packed`` (l.639) and
    the bfloat16 kernel round it (a no-op in float32)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale  # (B, h, Sq, Sk) f32
    if key_valid_mask is not None:
        logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    keep = _dropout_keep(dropout_rate, dropout_seed, keep_mask, b, h, sq, sk, q.device)
    if keep is not None:
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    return torch.matmul(probs.to(dtype).float(), v), lse


def flash_attention_packed_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's (#1) function in plain PyTorch.

    Args:
        query: (B, Sq, h*d); key: (B, Sk, h*d); value: (B, Sk, h*dv).
        key_valid_mask: (B, Sk) bool, True = attendable; masked keys get -1e9.
        dropout_rate / dropout_seed: the kernels' Philox dropout, or
        keep_mask: an explicit (B, h, Sq, Sk) bool keep mask instead.

    Returns:
        out (B, Sq, h*dv) in the input dtype, lse (B, h, Sq) float32 (of the
        undropped probabilities).
    """
    b, sq, hd = query.shape
    hdv = value.shape[-1]
    scale = _scale_of(scale, hd // num_heads)
    with torch.autocast(query.device.type, enabled=False):
        out, lse = _attention(_heads(query, num_heads), _heads(key, num_heads), _heads(value, num_heads),
                              key_valid_mask, scale, dropout_rate, dropout_seed, keep_mask, query.dtype)
    out = out.transpose(1, 2).reshape(b, sq, hdv).to(query.dtype)
    return out, lse


def flash_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The head-major forward kernel's (#5) function in plain PyTorch: that
    of :func:`flash_attention_packed_reference` on query (B, h, Sq, d), key
    (B, h, Sk, d) and value (B, h, Sk, dv). Returns out (B, h, Sq, dv) in the
    query dtype and lse (B, h, Sq) float32."""
    scale = _scale_of(scale, query.shape[-1])
    with torch.autocast(query.device.type, enabled=False):
        out, lse = _attention(query.float(), key.float(), value.float(), key_valid_mask, scale,
                              dropout_rate, dropout_seed, keep_mask, query.dtype)
    return out.to(query.dtype), lse


def _backward_terms(q, k, v, do, o, key_valid_mask, lse, scale, dropout_rate, dropout_seed, keep_mask):
    """What both backward passes recompute, on head-major float32 operands
    (the written-out gradient of the forward, not autograd):

        p = exp(s - lse), dp = keep/(1-rate) * dO v^T, delta = rowsum(dO * O)
        ds = p * (dp - delta)          (0 at masked keys: their logit is -1e9)
        (p = 1/Sk in a fully masked row, whose float32 lse cannot hold
        -1e9 + log(Sk))

    Returns (q, k, dO, keep/(1-rate) * p, ds, scale)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_valid_mask is not None:
        logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
    # a fully masked row's lse, -1e9 + log(Sk), rounds to -1e9 in float32:
    # its probabilities are the uniform 1/Sk its forward used
    p = torch.where(lse[..., None] < _FULLY_MASKED_LSE, 1.0 / sk, torch.exp(logits - lse[..., None]))
    dp = torch.matmul(do, v.transpose(-1, -2))
    keep = _dropout_keep(dropout_rate, dropout_seed, keep_mask, b, h, sq, sk, q.device)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if key_valid_mask is not None:
        ds = ds.masked_fill(~key_valid_mask[:, None, None, :], 0.0)
    return q, k, do, pd, ds, scale


def _packed_terms(query, key, value, num_heads, key_valid_mask, out, lse, d_out, scale,
                  dropout_rate, dropout_seed, keep_mask):
    h = num_heads
    return _backward_terms(_heads(query, h), _heads(key, h), _heads(value, h), _heads(d_out, h),
                           _heads(out, h), key_valid_mask, lse, _scale_of(scale, query.shape[-1] // h),
                           dropout_rate, dropout_seed, keep_mask)


def _unpacked_terms(query, key, value, key_valid_mask, out, lse, d_out, scale,
                    dropout_rate, dropout_seed, keep_mask):
    return _backward_terms(query.float(), key.float(), value.float(), d_out.float(), out.float(),
                           key_valid_mask, lse, _scale_of(scale, query.shape[-1]),
                           dropout_rate, dropout_seed, keep_mask)


def _packed(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).reshape(like.shape).to(like.dtype)


def _dq_heads(terms) -> torch.Tensor:
    q, k, do, pd, ds, scale = terms
    return torch.matmul(ds, k) * scale


def _dkv_heads(terms) -> tuple[torch.Tensor, torch.Tensor]:
    q, k, do, pd, ds, scale = terms
    return torch.matmul(ds.transpose(-1, -2), q) * scale, torch.matmul(pd.transpose(-1, -2), do)


def flash_attention_dq_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dQ kernel's (#3) function in plain PyTorch: dQ = scale * ds K
    (:func:`_backward_terms`), in the query dtype."""
    with torch.autocast(query.device.type, enabled=False):
        terms = _packed_terms(query, key, value, num_heads, key_valid_mask, out, lse, d_out,
                              scale, dropout_rate, dropout_seed, keep_mask)
        return _packed(_dq_heads(terms), query)


def flash_attention_dkv_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK / dV kernel's (#4) function in plain PyTorch: dK = scale *
    ds^T Q, dV = (keep/(1-rate) * p)^T dO (:func:`_backward_terms`), in the
    dtypes of key and value."""
    with torch.autocast(query.device.type, enabled=False):
        terms = _packed_terms(query, key, value, num_heads, key_valid_mask, out, lse, d_out,
                              scale, dropout_rate, dropout_seed, keep_mask)
        dk, dv = _dkv_heads(terms)
        return _packed(dk, key), _packed(dv, value)


def flash_attention_packed_backward_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward kernel's (#2) function in plain PyTorch, from the
    forward's out and lse: the dQ of :func:`flash_attention_dq_reference` and
    the dK, dV of :func:`flash_attention_dkv_reference` from one computation
    of their shared terms. Returns (dQ, dK, dV) in the dtypes of query, key
    and value."""
    with torch.autocast(query.device.type, enabled=False):
        terms = _packed_terms(query, key, value, num_heads, key_valid_mask, out, lse, d_out,
                              scale, dropout_rate, dropout_seed, keep_mask)
        dk, dv = _dkv_heads(terms)
        return _packed(_dq_heads(terms), query), _packed(dk, key), _packed(dv, value)


def flash_attention_unpacked_dq_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_valid_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The head-major dQ kernel's (#6) function in plain PyTorch: that of
    :func:`flash_attention_dq_reference` on (B, h, S, d) operands; dQ in the
    query dtype."""
    with torch.autocast(query.device.type, enabled=False):
        terms = _unpacked_terms(query, key, value, key_valid_mask, out, lse, d_out,
                                scale, dropout_rate, dropout_seed, keep_mask)
        return _dq_heads(terms).to(query.dtype)


def flash_attention_unpacked_dkv_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_valid_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The head-major dK / dV kernel's (#7) function in plain PyTorch: that
    of :func:`flash_attention_dkv_reference` on (B, h, S, d) operands; dK in
    the key dtype, dV in the value dtype."""
    with torch.autocast(query.device.type, enabled=False):
        terms = _unpacked_terms(query, key, value, key_valid_mask, out, lse, d_out,
                                scale, dropout_rate, dropout_seed, keep_mask)
        dk, dv = _dkv_heads(terms)
        return dk.to(key.dtype), dv.to(value.dtype)


def _check_device_dtype(name, query, key, value, key_valid_mask, extra) -> list[torch.Tensor]:
    """Every operand on one CUDA device, q / k / v float32 or bfloat16 alike;
    returns the operands."""
    tensors = [query, key, value, *extra] + ([key_valid_mask] if key_valid_mask is not None else [])
    if not all(t.is_cuda and t.device == query.device for t in tensors):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if query.dtype not in _DTYPE_CODES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{query.dtype}/{key.dtype}/{value.dtype}"
        )
    return tensors


def _check(name, query, key, value, num_heads, key_valid_mask, extra=()) -> tuple[int, int, int]:
    tensors = _check_device_dtype(name, query, key, value, key_valid_mask, extra)
    if query.dim() != 3 or key.dim() != 3 or value.dim() != 3:
        raise ValueError("q, k, v must be (B, S, h*d)")
    b, sq, hd = query.shape
    if key.shape[0] != b or value.shape[0] != b or key.shape[2] != hd or value.shape[1] != key.shape[1]:
        raise ValueError(
            f"shape mismatch: q {tuple(query.shape)}, k {tuple(key.shape)}, v {tuple(value.shape)}"
        )
    if hd % num_heads or value.shape[2] % num_heads:
        raise ValueError(f"feature widths {hd}, {value.shape[2]} not divisible by {num_heads} heads")
    if hd // num_heads > _MAX_HEAD_DIM or value.shape[2] // num_heads > _MAX_HEAD_DIM:
        raise ValueError(f"head widths above {_MAX_HEAD_DIM} are not supported by the CUDA kernels")
    if min(sq, key.shape[1]) == 0:
        raise ValueError("empty query or key sequence")
    if key_valid_mask is not None and (
        key_valid_mask.dtype != torch.bool or tuple(key_valid_mask.shape) != (b, key.shape[1])
    ):
        raise ValueError("key_valid_mask must be a (B, Sk) bool tensor")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    return b, sq, hd


def seed_tensor(seed, device: torch.device) -> torch.Tensor:
    """The seed as the kernels read it: a one-element int64 tensor on
    ``device`` (the tensor itself where it is one; an int is written to a new
    one by a fill, which a CUDA graph may capture)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != device:
            raise ValueError(f"a seed tensor must be one int64 element on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed.reshape(1)
    return torch.full((1,), int(seed) & _MASK32, dtype=torch.int64, device=device)


def _dropout_args(rate: float, seed, device: torch.device) -> tuple[Optional[torch.Tensor], int, float]:
    """(seed tensor, threshold, 1 / (1 - rate)) for the kernels; threshold 0
    = off (and no seed)."""
    if rate <= 0.0:
        return None, 0, 1.0
    if seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate {rate} outside (0, 1)")
    return seed_tensor(seed, device), dropout_threshold(rate), 1.0 / (1.0 - rate)


def _check_unpacked(name, query, key, value, key_valid_mask, extra=()) -> tuple[int, ...]:
    """The head-major kernels' operand checks; returns (b, h, sq, sk, d, dv).
    q, k, v (and ``extra``) may be views with their own strides, as long as
    the last dimension is contiguous and no two elements share an address."""
    tensors = _check_device_dtype(name, query, key, value, key_valid_mask, extra)
    if query.dim() != 4 or key.dim() != 4 or value.dim() != 4:
        raise ValueError("q, k, v must be (B, h, S, d)")
    b, h, sq, d = query.shape
    sk, dv = key.shape[2], value.shape[3]
    if tuple(key.shape) != (b, h, sk, d) or tuple(value.shape[:3]) != (b, h, sk):
        raise ValueError(
            f"shape mismatch: q {tuple(query.shape)}, k {tuple(key.shape)}, v {tuple(value.shape)}"
        )
    if max(d, dv) > _MAX_HEAD_DIM:
        raise ValueError(f"head widths above {_MAX_HEAD_DIM} are not supported by the CUDA kernels")
    if min(sq, sk) == 0:
        raise ValueError("empty query or key sequence")
    if key_valid_mask is not None and (
        key_valid_mask.dtype != torch.bool or tuple(key_valid_mask.shape) != (b, sk)
        or not key_valid_mask.is_contiguous()
    ):
        raise ValueError("key_valid_mask must be a contiguous (B, Sk) bool tensor")
    for t in tensors[:3] + [t for t in extra if t.dim() == 4]:
        if t.stride(-1) != 1 or any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
            raise ValueError(f"{name} operands need a contiguous last dimension and no broadcast axis")
    return b, h, sq, sk, d, dv


def _packed_strides(x: torch.Tensor, width: int) -> tuple[int, int, int]:
    """(batch, head, row) element strides of a contiguous (B, S, h*width)."""
    return x.stride(0), width, x.stride(1)


def _unpacked_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) element strides of a (B, h, S, width) view."""
    return x.stride(0), x.stride(1), x.stride(2)


def _empty_as(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor with x's shape, dtype and strides (a kernel
    writes a gradient with the strides of its operand)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)


class FlashAttentionForward(LaunchCounter):
    """The forward kernel's wrapper: checks the operands, allocates the
    outputs and launches on the current stream. ``unpacked=False`` is kernel
    #1 on head-packed (B, S, h*d) operands, ``unpacked=True`` kernel #5 on
    head-major (B, h, S, d) operands (views with their own strides too).
    ``launches`` counts kernel launches and nothing else."""

    library = FWD_LIBRARY

    def __init__(self, unpacked: bool = False):
        self.unpacked = unpacked
        super().__init__()

    def __call__(self, query, key, value, *args, **kwargs):
        """Packed: (query, key, value, num_heads, key_valid_mask=None,
        scale=None, dropout_rate=0.0, dropout_seed=None) -> out (B, Sq, h*dv),
        lse (B, h, Sq). Unpacked: the same without ``num_heads`` -> out (B, h,
        Sq, dv), lse (B, h, Sq). out is in the input dtype, lse float32."""
        if self.unpacked:
            return self._run(query, key, value, None, *args, **kwargs)
        return self._run(query, key, value, *args, **kwargs)

    def _run(self, query, key, value, num_heads, key_valid_mask=None, scale=None,
             dropout_rate: float = 0.0, dropout_seed=None):
        if num_heads is None:
            name = "flash_attention_unpacked_fwd"
            b, h, sq, sk, d, dv = _check_unpacked(name, query, key, value, key_valid_mask)
            out = torch.empty((b, h, sq, dv), dtype=query.dtype, device=query.device)
            strides = [*_unpacked_strides(query), *_unpacked_strides(key), *_unpacked_strides(value),
                       *_unpacked_strides(out)]
        else:
            name, h = "flash_attention_fwd", num_heads
            b, sq, hd = _check(name, query, key, value, h, key_valid_mask)
            sk, hdv = key.shape[1], value.shape[-1]
            d, dv = hd // h, hdv // h
            out = torch.empty((b, sq, hdv), dtype=query.dtype, device=query.device)
            strides = [*_packed_strides(query, d), *_packed_strides(key, d), *_packed_strides(value, dv),
                       *_packed_strides(out, dv)]
        seed, threshold, inv_keep = _dropout_args(dropout_rate, dropout_seed, query.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=query.device)
        lib = self.library.library()
        with torch.cuda.device(query.device):
            stream = torch.cuda.current_stream(query.device).cuda_stream
            err = lib.odtt_flash_attention_fwd(
                query.data_ptr(), key.data_ptr(), value.data_ptr(),
                key_valid_mask.data_ptr() if key_valid_mask is not None else None,
                out.data_ptr(), lse.data_ptr(), (ctypes.c_longlong * 12)(*strides),
                _DTYPE_CODES[query.dtype], b, sq, sk, h, d, dv, float(_scale_of(scale, d)),
                None if seed is None else seed.data_ptr(), threshold, inv_keep, stream,
            )
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        self.count_launch(stream)
        return out, lse


def _backward_operands(name, query, key, value, num_heads, key_valid_mask, out, lse, d_out,
                       scale, dropout_rate, dropout_seed):
    """Checks a backward kernel's operands; returns (b, sq, sk, d, dv, scale,
    (seed, threshold, inv_keep), delta) with delta = rowsum(dO * O) per head,
    (B, h, Sq) float32, computed beside the kernels as _delta_packed (l.973)
    computes it."""
    b, sq, hd = _check(name, query, key, value, num_heads, key_valid_mask, extra=(out, d_out, lse))
    sk, hdv = key.shape[1], value.shape[-1]
    d, dv = hd // num_heads, hdv // num_heads
    if out.shape != (b, sq, hdv) or d_out.shape != (b, sq, hdv) or out.dtype != query.dtype \
            or d_out.dtype != query.dtype:
        raise ValueError("out and d_out must be (B, Sq, h*dv) in the input dtype")
    if lse.shape != (b, num_heads, sq) or lse.dtype != torch.float32:
        raise ValueError("lse must be (B, h, Sq) float32")
    dropout = _dropout_args(dropout_rate, dropout_seed, query.device)
    delta = (d_out.float() * out.float()).view(b, sq, num_heads, dv).sum(-1)
    delta = delta.transpose(1, 2).contiguous()  # (B, h, Sq)
    return b, sq, sk, d, dv, float(_scale_of(scale, d)), dropout, delta


def _unpacked_backward_operands(name, query, key, value, key_valid_mask, out, lse, d_out,
                                scale, dropout_rate, dropout_seed):
    """:func:`_backward_operands` for head-major operands: returns (b, h, sq,
    sk, d, dv, scale, (seed, threshold, inv_keep), delta)."""
    b, h, sq, sk, d, dv = _check_unpacked(name, query, key, value, key_valid_mask,
                                          extra=(out, d_out, lse))
    if tuple(out.shape) != (b, h, sq, dv) or tuple(d_out.shape) != (b, h, sq, dv) \
            or out.dtype != query.dtype or d_out.dtype != query.dtype:
        raise ValueError("out and d_out must be (B, h, Sq, dv) in the input dtype")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous (B, h, Sq) float32 tensor")
    dropout = _dropout_args(dropout_rate, dropout_seed, query.device)
    delta = (d_out.float() * out.float()).sum(-1).contiguous()  # (B, h, Sq)
    return b, h, sq, sk, d, dv, float(_scale_of(scale, d)), dropout, delta


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _plan(d: int, dv: int, dtype: torch.dtype, device: torch.device, fused: Optional[bool]) -> str:
    """The backward to run: ``fused`` None follows :func:`backward_plan` (with
    the device's opt-in shared memory per block on CUDA); True where the
    fused kernel cannot run raises, as ``_bwd_impl_packed`` does."""
    limit = _smem_optin(device.index if device.index is not None else torch.cuda.current_device()) \
        if device.type == "cuda" else None
    plan = backward_plan(d, dv, dtype, limit)
    if fused and plan != "fused":
        raise ValueError(f"fused backward requested but it cannot run at head widths d={d}, dv={dv} "
                         f"({dtype}, {limit} bytes of shared memory a block)")
    if fused is None:
        return plan
    return "fused" if fused else "two_pass"


class FlashAttentionBackward(LaunchCounter):
    """The fused backward kernel's (#2) wrapper: dQ, dK, dV in one launch.
    Computes delta beside the kernel, zeroes the float32 dQ buffer the kernel
    adds into and casts it to the query dtype after. Raises where
    :func:`backward_plan` says the kernel does not fit the device.
    ``launches`` counts kernel launches and nothing else. In bfloat16 the
    kernel feeds dS and P keep to the tensor cores as hi / lo bf16 pairs."""

    library = BWD_LIBRARY

    def __init__(self):
        super().__init__()

    def __call__(self, query, key, value, num_heads, key_valid_mask, out, lse, d_out,
                 scale=None, dropout_rate: float = 0.0, dropout_seed=None):
        b, sq, sk, d, dv, scale, (seed, threshold, inv_keep), delta = _backward_operands(
            "flash_attention_bwd", query, key, value, num_heads, key_valid_mask, out, lse, d_out,
            scale, dropout_rate, dropout_seed)
        _plan(d, dv, query.dtype, query.device, True)
        dq = torch.zeros(query.shape, dtype=torch.float32, device=query.device)
        dk = torch.empty_like(key)
        dvv = torch.empty_like(value)
        lib = self.library.library()
        with torch.cuda.device(query.device):
            stream = torch.cuda.current_stream(query.device).cuda_stream
            err = lib.odtt_flash_attention_bwd(
                query.data_ptr(), key.data_ptr(), value.data_ptr(),
                key_valid_mask.data_ptr() if key_valid_mask is not None else None,
                d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dvv.data_ptr(), _DTYPE_CODES[query.dtype],
                b, sq, sk, num_heads, d, dv, scale, None if seed is None else seed.data_ptr(), threshold,
                inv_keep, stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
        self.count_launch(stream)
        return dq.to(query.dtype), dk, dvv


class FlashAttentionTwoPass(LaunchCounter):
    """The wrapper of one pass of the two-pass backward: ``dq=True`` kernel
    #3 (returns dQ), ``dq=False`` kernel #4 (returns dK, dV) on head-packed
    (B, S, h*d) operands; with ``unpacked=True`` the same kernels as #6 and
    #7 on head-major (B, h, S, d) operands (views with their own strides too;
    each gradient has its operand's strides). Each computes delta beside its
    kernel and writes its gradients once, in the input dtype. ``launches``
    counts kernel launches and nothing else. In bfloat16 the kernels run on
    the tensor cores and feed dS and P keep to them as hi / lo bf16 pairs."""

    library = TWO_PASS_LIBRARY

    def __init__(self, dq: bool, unpacked: bool = False):
        self.dq = dq
        self.unpacked = unpacked
        super().__init__()

    @property
    def name(self) -> str:
        return "flash_attention_" + ("unpacked_" if self.unpacked else "") + ("dq" if self.dq else "dkv")

    def __call__(self, query, key, value, *args, **kwargs):
        """Packed: (query, key, value, num_heads, key_valid_mask, out, lse,
        d_out, scale=None, dropout_rate=0.0, dropout_seed=None); unpacked: the
        same without ``num_heads``."""
        if self.unpacked:
            return self._run(query, key, value, None, *args, **kwargs)
        return self._run(query, key, value, *args, **kwargs)

    def _run(self, query, key, value, num_heads, key_valid_mask, out, lse, d_out,
             scale=None, dropout_rate: float = 0.0, dropout_seed=None):
        if num_heads is None:
            b, h, sq, sk, d, dv, scale, dropout, delta = _unpacked_backward_operands(
                self.name, query, key, value, key_valid_mask, out, lse, d_out,
                scale, dropout_rate, dropout_seed)
            strides = [*_unpacked_strides(query), *_unpacked_strides(key), *_unpacked_strides(value),
                       *_unpacked_strides(d_out)]
        else:
            h = num_heads
            b, sq, sk, d, dv, scale, dropout, delta = _backward_operands(
                self.name, query, key, value, h, key_valid_mask, out, lse, d_out,
                scale, dropout_rate, dropout_seed)
            strides = [*_packed_strides(query, d), *_packed_strides(key, d), *_packed_strides(value, dv),
                       *_packed_strides(d_out, dv)]
        seed, threshold, inv_keep = dropout
        if self.dq:
            dq, dk, dvv = _empty_as(query), None, None
        else:
            dq, dk, dvv = None, _empty_as(key), _empty_as(value)
        lib = self.library.library()
        with torch.cuda.device(query.device):
            stream = torch.cuda.current_stream(query.device).cuda_stream
            err = lib.odtt_flash_attention_two_pass(
                int(self.dq), *(None if t is None else t.data_ptr() for t in (
                    query, key, value, key_valid_mask, d_out, lse, delta, dq, dk, dvv)),
                (ctypes.c_longlong * 12)(*strides), _DTYPE_CODES[query.dtype],
                b, sq, sk, h, d, dv, scale, None if seed is None else seed.data_ptr(), threshold, inv_keep,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.count_launch(stream)
        return dq if self.dq else (dk, dvv)


flash_attention_fwd = FlashAttentionForward()
flash_attention_bwd = FlashAttentionBackward()
flash_attention_dq = FlashAttentionTwoPass(dq=True)
flash_attention_dkv = FlashAttentionTwoPass(dq=False)
flash_attention_unpacked_fwd = FlashAttentionForward(unpacked=True)
flash_attention_unpacked_dq = FlashAttentionTwoPass(dq=True, unpacked=True)
flash_attention_unpacked_dkv = FlashAttentionTwoPass(dq=False, unpacked=True)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel #1 and the backward of :func:`_plan` (kernel #2, or
    kernels #3 and #4) as one differentiable op (the custom VJP of
    flash_attention.py:1201-1220)."""

    @staticmethod
    def forward(ctx, query, key, value, num_heads, key_valid_mask, scale, rate, seed, keep_mask, fused):
        if seed is not None:
            seed = seed_tensor(seed, query.device)  # the forward's seed, saved for the backward
        if query.is_cuda:
            if keep_mask is not None:
                raise ValueError("the CUDA kernels draw their own Philox keep mask")
            out, lse = flash_attention_fwd(query, key, value, num_heads, key_valid_mask,
                                           scale, rate, seed)
        else:
            out, lse = flash_attention_packed_reference(
                query, key, value, num_heads, key_valid_mask, scale, rate, seed, keep_mask
            )
        ctx.save_for_backward(query, key, value, key_valid_mask, out, lse, keep_mask, seed)
        ctx.params = (num_heads, scale, rate, fused)
        return out

    @staticmethod
    def backward(ctx, d_out):
        query, key, value, key_valid_mask, out, lse, keep_mask, seed = ctx.saved_tensors
        num_heads, scale, rate, fused = ctx.params
        d_out = d_out.contiguous().to(query.dtype)
        d, dv = query.shape[-1] // num_heads, value.shape[-1] // num_heads
        plan = _plan(d, dv, query.dtype, query.device, fused)
        args = (query, key, value, num_heads, key_valid_mask, out, lse, d_out, scale, rate, seed)
        if query.is_cuda:
            if plan == "fused":
                dq, dk, dv = flash_attention_bwd(*args)
            else:
                dq = flash_attention_dq(*args)
                dk, dv = flash_attention_dkv(*args)
        elif plan == "fused":
            dq, dk, dv = flash_attention_packed_backward_reference(*args, keep_mask)
        else:
            dq = flash_attention_dq_reference(*args, keep_mask)
            dk, dv = flash_attention_dkv_reference(*args, keep_mask)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_packed(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    scale: Optional[float] = None,
    keep_mask: Optional[torch.Tensor] = None,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Head-packed fused masked attention with dropout, differentiable,
    (B, Sq, h*dv) in the input dtype.

    CUDA operands go through kernel #1 forward and kernel #2 or kernels #3
    and #4 backward; CPU operands through their plain versions. ``fused``
    picks the backward as ``_bwd_impl_packed(fused=...)`` does: None by
    :func:`backward_plan`, True the fused one (raising where it cannot run),
    False the two-pass one. ``keep_mask`` (CPU only) replaces the Philox draw.
    """
    if dropout_rate <= 0.0:
        dropout_seed, keep_mask = None, None
    with torch.autocast(query.device.type, enabled=False):
        return _FlashAttention.apply(
            query.contiguous(), key.contiguous(), value.contiguous(), num_heads,
            None if key_valid_mask is None else key_valid_mask.contiguous(),
            scale, float(dropout_rate), dropout_seed, keep_mask, fused,
        )


class _FlashAttentionUnpacked(torch.autograd.Function):
    """Forward kernel #5 and the two-pass backward #6 / #7 as one
    differentiable op (the custom VJP of flash_attention.py:530-565)."""

    @staticmethod
    def forward(ctx, query, key, value, key_valid_mask, scale, rate, seed, keep_mask):
        if seed is not None:
            seed = seed_tensor(seed, query.device)  # the forward's seed, saved for the backward
        if query.is_cuda:
            if keep_mask is not None:
                raise ValueError("the CUDA kernels draw their own Philox keep mask")
            out, lse = flash_attention_unpacked_fwd(query, key, value, key_valid_mask, scale, rate, seed)
        else:
            out, lse = flash_attention_reference(query, key, value, key_valid_mask, scale, rate, seed, keep_mask)
        ctx.save_for_backward(query, key, value, key_valid_mask, out, lse, keep_mask, seed)
        ctx.params = (scale, rate)
        return out

    @staticmethod
    def backward(ctx, d_out):
        query, key, value, key_valid_mask, out, lse, keep_mask, seed = ctx.saved_tensors
        scale, rate = ctx.params
        d_out = _last_dim_contiguous(d_out.to(query.dtype))
        args = (query, key, value, key_valid_mask, out, lse, d_out, scale, rate, seed)
        if query.is_cuda:
            dq = flash_attention_unpacked_dq(*args)
            dk, dv = flash_attention_unpacked_dkv(*args)
        else:
            dq = flash_attention_unpacked_dq_reference(*args, keep_mask)
            dk, dv = flash_attention_unpacked_dkv_reference(*args, keep_mask)
        return dq, dk, dv, None, None, None, None, None


def _last_dim_contiguous(x: torch.Tensor) -> torch.Tensor:
    """x itself where the head-major kernels take its strides, else a copy."""
    if x.stride(-1) == 1 and not any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        return x
    return x.contiguous()


def _unpacked_operands(query, key, value, key_valid_mask, dropout_rate, dropout_seed, keep_mask):
    if dropout_rate > 0.0 and dropout_seed is None and keep_mask is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    if dropout_rate <= 0.0:
        dropout_seed, keep_mask = None, None
    mask = None if key_valid_mask is None else key_valid_mask.contiguous()
    seed = dropout_seed
    return (*map(_last_dim_contiguous, (query, key, value)), mask, seed, keep_mask)


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_valid_mask: Optional[torch.Tensor] = None,
    dropout_seed: Optional[Seed] = None,
    dropout_rate: float = 0.0,
    *,
    scale: Optional[float] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused masked attention, forward only (flash_attention.py:307).

    Args:
        query: (B, h, Sq, d); key: (B, h, Sk, d); value: (B, h, Sk, dv). A
            view whose last dimension is contiguous, such as a (B, S, h, d)
            tensor transposed to (B, h, S, d), is read in place on CUDA.
        key_valid_mask: (B, Sk) bool, True = attendable.
        dropout_seed: an int or a one-element int64 tensor; required when
            dropout_rate > 0 (or ``keep_mask``,
            an explicit (B, h, Sq, Sk) keep mask, CPU only).
        scale: defaults to 1/sqrt(d).

    Returns:
        (B, h, Sq, dv) in the query dtype, without a graph: kernel #5 for
        CUDA operands, its plain version for CPU ones.
    """
    q, k, v, mask, seed, keep_mask = _unpacked_operands(query, key, value, key_valid_mask, dropout_rate,
                                                        dropout_seed, keep_mask)
    with torch.no_grad(), torch.autocast(query.device.type, enabled=False):
        if q.is_cuda:
            if keep_mask is not None:
                raise ValueError("the CUDA kernels draw their own Philox keep mask")
            out, _ = flash_attention_unpacked_fwd(q, k, v, mask, scale, float(dropout_rate), seed)
        else:
            out, _ = flash_attention_reference(q, k, v, mask, scale, float(dropout_rate), seed, keep_mask)
    return out


def flash_attention_trainable(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    key_valid_mask: Optional[torch.Tensor] = None,
    dropout_seed: Optional[Seed] = None,
    dropout_rate: float = 0.0,
    *,
    scale: Optional[float] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`flash_attention` with a backward (flash_attention.py:531):
    gradients flow to query, key and value (the two-pass kernels #6 and #7 on
    CUDA, their plain versions on the CPU), the same keep mask regenerated
    from the seed; the mask and the seed are constants. dQ is in the query
    dtype, dK in the key dtype, dV in the value dtype."""
    q, k, v, mask, seed, keep_mask = _unpacked_operands(query, key, value, key_valid_mask, dropout_rate,
                                                        dropout_seed, keep_mask)
    with torch.autocast(query.device.type, enabled=False):
        return _FlashAttentionUnpacked.apply(q, k, v, mask, scale, float(dropout_rate), seed, keep_mask)
