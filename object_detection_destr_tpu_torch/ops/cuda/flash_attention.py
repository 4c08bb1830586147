"""Head-packed flash attention with attention-probability dropout: the
hand-written CUDA kernels ``csrc/flash_attention_fwd.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward), their ctypes bindings, their
plain PyTorch versions, and the ``torch.autograd.Function`` that joins them.

Port of ``object_detection_destr_tpu/ops/pallas/flash_attention.py::
flash_attention_packed`` (l.1174): the forward ``_fwd_kernel_packed`` (l.592)
and the fused backward ``_dkvq_kernel_packed`` (l.884) behind its custom VJP.

Dropout: element (b, head, q, k) is kept iff its Philox4x32-10 bits (key
(seed, 0), counter (q, k, b*h + head, 0); ``csrc/philox.cuh``) are
``>= uint32(rate * 2**32)``, the rule of ``_drop_threshold`` (l.102-105), and
kept probabilities are scaled by ``1 / (1 - rate)``. The logsumexp is that of
the undropped probabilities. The TPU's own PRNG bits are not reproduced; the
plain version draws the same Philox bits as the kernels, or takes an explicit
``(B, h, Sq, Sk)`` keep mask (the CPU tests feed it the JAX package's
``dropout_keep_mask``).

A CUDA tensor launches the kernels or raises; a CPU tensor runs the plain
versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..attention import NEG_INF
from .build import CudaLibrary

__all__ = [
    "FlashAttentionBackward",
    "FlashAttentionForward",
    "dropout_threshold",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_backward_reference",
    "flash_attention_packed_reference",
    "philox_keep_bits",
]

_MAX_HEAD_DIM = 512
_FULLY_MASKED_LSE = -5e8  # below any row with a valid key; the kernels use the same bound
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
FWD_LIBRARY = CudaLibrary(
    "odtt_flash_attention_fwd", "flash_attention_fwd.cu",
    headers=("flash_common.cuh", "philox.cuh"),
    functions={"odtt_flash_attention_fwd": (_I, [_P] * 6 + [_I] * 7 + [_F, _U, _U, _F, _P])},
    abi=("odtt_flash_fwd_abi_version", 2),
)
BWD_LIBRARY = CudaLibrary(
    "odtt_flash_attention_bwd", "flash_attention_bwd.cu",
    headers=("flash_common.cuh", "philox.cuh"),
    functions={"odtt_flash_attention_bwd": (_I, [_P] * 10 + [_I] * 7 + [_F, _U, _U, _F, _P])},
    abi=("odtt_flash_bwd_abi_version", 1),
)


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


def philox_keep_bits(seed: int, bh: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 with key (seed, 0) and counter (q, k, bh, 0),
    as int64 in [0, 2**32); the three coordinate tensors broadcast. The same
    bits ``csrc/philox.cuh`` draws in the kernels."""
    c0, c1, c2 = (t.to(torch.int64) for t in (q, k, bh))
    c3 = torch.zeros((), dtype=torch.int64, device=c0.device)
    k0, k1 = seed & _MASK32, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def _keep_mask(seed: int, rate: float, b: int, h: int, sq: int, sk: int, device) -> torch.Tensor:
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
    return _keep_mask(int(seed), rate, b, h, sq, sk, device)


def flash_attention_packed_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch.

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
    sk, hdv = key.shape[1], value.shape[-1]
    d = hd // num_heads
    if scale is None:
        scale = 1.0 / d**0.5
    with torch.autocast(query.device.type, enabled=False):
        q, k, v = _heads(query, num_heads), _heads(key, num_heads), _heads(value, num_heads)
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale  # (B, h, Sq, Sk) f32
        if key_valid_mask is not None:
            logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        keep = _dropout_keep(dropout_rate, dropout_seed, keep_mask, b, num_heads, sq, sk, query.device)
        if keep is not None:
            probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
        out = torch.matmul(probs, v)
    out = out.transpose(1, 2).reshape(b, sq, hdv).to(query.dtype)
    return out, lse


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
    dropout_seed: Optional[int] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, written out (not
    autograd of the plain forward), from the forward's out and lse:

        p = exp(s - lse), dp = keep/(1-rate) * dO v^T, delta = rowsum(dO * O)
        ds = p * (dp - delta)          (0 at masked keys: their logit is -1e9)
        (p = 1/Sk in a fully masked row, whose float32 lse cannot hold
        -1e9 + log(Sk))
        dQ = scale * ds K, dK = scale * ds^T Q, dV = (keep/(1-rate) * p)^T dO

    Returns (dQ, dK, dV) in the dtypes of query, key and value.
    """
    b, sq, hd = query.shape
    sk = key.shape[1]
    d = hd // num_heads
    if scale is None:
        scale = 1.0 / d**0.5
    with torch.autocast(query.device.type, enabled=False):
        q, k, v = _heads(query, num_heads), _heads(key, num_heads), _heads(value, num_heads)
        do, o = _heads(d_out, num_heads), _heads(out, num_heads)
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        if key_valid_mask is not None:
            logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
        # a fully masked row's lse, -1e9 + log(Sk), rounds to -1e9 in float32:
        # its probabilities are the uniform 1/Sk its forward used
        p = torch.where(lse[..., None] < _FULLY_MASKED_LSE, 1.0 / sk, torch.exp(logits - lse[..., None]))
        dp = torch.matmul(do, v.transpose(-1, -2))
        keep = _dropout_keep(dropout_rate, dropout_seed, keep_mask, b, num_heads, sq, sk, query.device)
        pd = p
        if keep is not None:
            inv = 1.0 / (1.0 - dropout_rate)
            pd = torch.where(keep, p * inv, 0.0)
            dp = torch.where(keep, dp * inv, 0.0)
        delta = (do * o).sum(-1, keepdim=True)
        ds = p * (dp - delta)
        if key_valid_mask is not None:
            ds = ds.masked_fill(~key_valid_mask[:, None, None, :], 0.0)
        dq = torch.matmul(ds, k) * scale
        dk = torch.matmul(ds.transpose(-1, -2), q) * scale
        dv = torch.matmul(pd.transpose(-1, -2), do)

    def packed(x, like):
        return x.transpose(1, 2).reshape(like.shape).to(like.dtype)

    return packed(dq, query), packed(dk, key), packed(dv, value)


def _check(name, query, key, value, num_heads, key_valid_mask, extra=()) -> tuple[int, int, int]:
    tensors = [query, key, value, *extra] + ([key_valid_mask] if key_valid_mask is not None else [])
    if not all(t.is_cuda and t.device == query.device for t in tensors):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if query.dtype not in _DTYPE_CODES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{query.dtype}/{key.dtype}/{value.dtype}"
        )
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
        raise ValueError(f"head widths above {_MAX_HEAD_DIM} are not supported")
    if min(sq, key.shape[1]) == 0:
        raise ValueError("empty query or key sequence")
    if key_valid_mask is not None and (
        key_valid_mask.dtype != torch.bool or tuple(key_valid_mask.shape) != (b, key.shape[1])
    ):
        raise ValueError("key_valid_mask must be a (B, Sk) bool tensor")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    return b, sq, hd


def _dropout_args(rate: float, seed: Optional[int]) -> tuple[int, int, float]:
    """(seed, threshold, 1 / (1 - rate)) for the kernels; threshold 0 = off."""
    if rate <= 0.0:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate {rate} outside (0, 1)")
    return int(seed) & _MASK32, dropout_threshold(rate), 1.0 / (1.0 - rate)


class FlashAttentionForward:
    """The forward kernel's wrapper: checks the operands, allocates the
    outputs and launches on the current stream. ``launches`` counts kernel
    launches and nothing else."""

    library = FWD_LIBRARY

    def __init__(self):
        self.launches = 0

    def __call__(self, query, key, value, num_heads, key_valid_mask=None, scale=None,
                 dropout_rate: float = 0.0, dropout_seed: Optional[int] = None):
        """Returns out (B, Sq, h*dv) in the input dtype and lse (B, h, Sq) f32."""
        b, sq, hd = _check("flash_attention_fwd", query, key, value, num_heads, key_valid_mask)
        sk, hdv = key.shape[1], value.shape[-1]
        d, dv = hd // num_heads, hdv // num_heads
        if scale is None:
            scale = 1.0 / d**0.5
        seed, threshold, inv_keep = _dropout_args(dropout_rate, dropout_seed)
        out = torch.empty((b, sq, hdv), dtype=query.dtype, device=query.device)
        lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=query.device)
        lib = self.library.library()
        with torch.cuda.device(query.device):
            stream = torch.cuda.current_stream(query.device).cuda_stream
            err = lib.odtt_flash_attention_fwd(
                query.data_ptr(), key.data_ptr(), value.data_ptr(),
                key_valid_mask.data_ptr() if key_valid_mask is not None else None,
                out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[query.dtype],
                b, sq, sk, num_heads, d, dv, float(scale), seed, threshold, inv_keep, stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
        self.launches += 1
        return out, lse


class FlashAttentionBackward:
    """The backward kernel's wrapper: dQ, dK, dV in one launch. Computes
    delta = rowsum(dO * O) per head beside the kernel, zeroes the float32 dQ
    buffer the kernel adds into and casts it to the query dtype after.
    ``launches`` counts kernel launches and nothing else."""

    library = BWD_LIBRARY

    def __init__(self):
        self.launches = 0

    def __call__(self, query, key, value, num_heads, key_valid_mask, out, lse, d_out,
                 scale=None, dropout_rate: float = 0.0, dropout_seed: Optional[int] = None):
        b, sq, hd = _check("flash_attention_bwd", query, key, value, num_heads, key_valid_mask,
                           extra=(out, d_out, lse))
        sk, hdv = key.shape[1], value.shape[-1]
        d, dv = hd // num_heads, hdv // num_heads
        if scale is None:
            scale = 1.0 / d**0.5
        if out.shape != (b, sq, hdv) or d_out.shape != (b, sq, hdv) or out.dtype != query.dtype \
                or d_out.dtype != query.dtype:
            raise ValueError("out and d_out must be (B, Sq, h*dv) in the input dtype")
        if lse.shape != (b, num_heads, sq) or lse.dtype != torch.float32:
            raise ValueError("lse must be (B, h, Sq) float32")
        seed, threshold, inv_keep = _dropout_args(dropout_rate, dropout_seed)
        delta = (d_out.float() * out.float()).view(b, sq, num_heads, dv).sum(-1)
        delta = delta.transpose(1, 2).contiguous()  # (B, h, Sq)
        dq = torch.zeros((b, sq, hd), dtype=torch.float32, device=query.device)
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
                b, sq, sk, num_heads, d, dv, float(scale), seed, threshold, inv_keep, stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
        self.launches += 1
        return dq.to(query.dtype), dk, dvv


flash_attention_fwd = FlashAttentionForward()
flash_attention_bwd = FlashAttentionBackward()


class _FlashAttention(torch.autograd.Function):
    """Forward kernel #1 and backward kernel #2 as one differentiable op
    (the custom VJP of flash_attention.py:1201-1220)."""

    @staticmethod
    def forward(ctx, query, key, value, num_heads, key_valid_mask, scale, rate, seed, keep_mask):
        if query.is_cuda:
            if keep_mask is not None:
                raise ValueError("the CUDA kernels draw their own Philox keep mask")
            out, lse = flash_attention_fwd(query, key, value, num_heads, key_valid_mask,
                                           scale, rate, seed)
        else:
            out, lse = flash_attention_packed_reference(
                query, key, value, num_heads, key_valid_mask, scale, rate, seed, keep_mask
            )
        ctx.save_for_backward(query, key, value, key_valid_mask, out, lse, keep_mask)
        ctx.params = (num_heads, scale, rate, seed)
        return out

    @staticmethod
    def backward(ctx, d_out):
        query, key, value, key_valid_mask, out, lse, keep_mask = ctx.saved_tensors
        num_heads, scale, rate, seed = ctx.params
        d_out = d_out.contiguous().to(query.dtype)
        if query.is_cuda:
            dq, dk, dv = flash_attention_bwd(query, key, value, num_heads, key_valid_mask,
                                             out, lse, d_out, scale, rate, seed)
        else:
            dq, dk, dv = flash_attention_packed_backward_reference(
                query, key, value, num_heads, key_valid_mask, out, lse, d_out, scale,
                rate, seed, keep_mask,
            )
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_packed(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    scale: Optional[float] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Head-packed fused masked attention with dropout, differentiable,
    (B, Sq, h*dv) in the input dtype.

    CUDA operands go through kernels #1 and #2; CPU operands through their
    plain versions. ``keep_mask`` (CPU only) replaces the Philox draw.
    """
    if dropout_rate <= 0.0:
        dropout_seed, keep_mask = None, None
    with torch.autocast(query.device.type, enabled=False):
        return _FlashAttention.apply(
            query.contiguous(), key.contiguous(), value.contiguous(), num_heads,
            None if key_valid_mask is None else key_valid_mask.contiguous(),
            scale, float(dropout_rate), dropout_seed, keep_mask,
        )
