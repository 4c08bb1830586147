"""Head-packed flash-attention forward: the hand-written CUDA kernel
``csrc/flash_attention_fwd.cu``, its build and ctypes binding, and its plain
PyTorch version.

Port of ``object_detection_destr_tpu/ops/pallas/flash_attention.py::
flash_attention_packed`` (forward only; the backward and in-kernel dropout
arrive with the training slice).

The library is built with ``nvcc`` at first use into ``_build/`` beside the
package sources, and rebuilt when the source is newer. A CUDA tensor launches
the kernel or raises; a CPU tensor runs :func:`flash_attention_packed_reference`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from ..attention import NEG_INF

__all__ = [
    "FlashAttentionForward",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_reference",
]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_PKG, "csrc", "flash_attention_fwd.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libodtt_flash_attention_fwd.so")
_ABI_VERSION = 1
_MAX_HEAD_DIM = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def flash_attention_packed_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch.

    Args:
        query: (B, Sq, h*d); key: (B, Sk, h*d); value: (B, Sk, h*dv).
        key_valid_mask: (B, Sk) bool, True = attendable; masked keys get -1e9.

    Returns:
        out (B, Sq, h*dv) in the input dtype, lse (B, h, Sq) float32.
    """
    b, sq, hd = query.shape
    sk, hdv = key.shape[1], value.shape[-1]
    d, dv = hd // num_heads, hdv // num_heads
    if scale is None:
        scale = 1.0 / d**0.5
    q = query.float().reshape(b, sq, num_heads, d).transpose(1, 2)
    k = key.float().reshape(b, sk, num_heads, d).transpose(1, 2)
    v = value.float().reshape(b, sk, num_heads, dv).transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale  # (B, h, Sq, Sk) f32
    if key_valid_mask is not None:
        logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    out = out.transpose(1, 2).reshape(b, sq, hdv).to(query.dtype)
    return out, lse


class FlashAttentionForward:
    """The CUDA kernel's wrapper: builds and loads the library, checks the
    operands, allocates the outputs and launches on the current stream.

    ``launches`` counts kernel launches and nothing else, so a run can show
    that the model went through the kernel.
    """

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self) -> float:
        """Compile the library if it is missing or older than its source.
        Returns the seconds spent compiling (0.0 when it was up to date)."""
        if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
            return 0.0
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, _SRC,
        ]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
        self.build_log = proc.stderr
        return time.perf_counter() - start

    def library(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(_LIB_PATH)
                lib.odtt_flash_fwd_abi_version.restype = ctypes.c_int
                lib.odtt_flash_fwd_abi_version.argtypes = []
                if lib.odtt_flash_fwd_abi_version() != _ABI_VERSION:
                    raise RuntimeError(f"{_LIB_PATH} has a stale ABI; delete it to rebuild")
                fn = lib.odtt_flash_attention_fwd
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                    ctypes.c_float, ctypes.c_void_p,
                ]
                self._lib = lib
        return self._lib

    def __call__(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        num_heads: int,
        key_valid_mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns out (B, Sq, h*dv) in the input dtype and lse (B, h, Sq) f32."""
        b, sq, hd = _check(query, key, value, num_heads, key_valid_mask)
        sk, hdv = key.shape[1], value.shape[-1]
        d, dv = hd // num_heads, hdv // num_heads
        if scale is None:
            scale = 1.0 / d**0.5
        out = torch.empty((b, sq, hdv), dtype=query.dtype, device=query.device)
        lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=query.device)
        lib = self.library()
        with torch.cuda.device(query.device):
            stream = torch.cuda.current_stream(query.device).cuda_stream
            err = lib.odtt_flash_attention_fwd(
                query.data_ptr(), key.data_ptr(), value.data_ptr(),
                key_valid_mask.data_ptr() if key_valid_mask is not None else None,
                out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[query.dtype],
                b, sq, sk, num_heads, d, dv, float(scale), stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
        self.launches += 1
        return out, lse


def _check(query, key, value, num_heads, key_valid_mask) -> tuple[int, int, int]:
    tensors = [query, key, value] + ([key_valid_mask] if key_valid_mask is not None else [])
    if not all(t.is_cuda and t.device == query.device for t in tensors):
        raise ValueError("flash_attention_fwd: every operand must be on one CUDA device")
    if query.dtype not in _DTYPE_CODES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(
            f"flash_attention_fwd takes float32 or bfloat16 q/k/v of one dtype, got "
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
        raise ValueError("flash_attention_fwd operands must be contiguous")
    return b, sq, hd


flash_attention_fwd = FlashAttentionForward()


def flash_attention_packed(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Head-packed fused masked attention, (B, Sq, h*dv) in the input dtype.

    CUDA operands go through the kernel; CPU operands through the plain
    version. Attention dropout is not on the serving path and raises.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout arrives with the training slice (Philox dropout in the kernel)"
        )
    if query.is_cuda:
        out, _ = flash_attention_fwd(query, key, value, num_heads, key_valid_mask, scale)
    else:
        out, _ = flash_attention_packed_reference(
            query, key, value, num_heads, key_valid_mask, scale
        )
    return out
