"""The precision argument of the float32 flash-attention forward on the
tensor cores (``csrc/flash_attention_fwd.cu::flash_fwd_f32_kernel``), on
the CPU.

The kernel splits every float32 operand of both products, S = Q K^T and
P V, into tf32 halves, big = tf32(x) and small = tf32(x - big), and sums
three tf32 products, small x big + big x small + big x big, in float32
(3xTF32). Here tf32 rounding is emulated in torch (round to nearest at 10
mantissa bits, ties away from zero, as ``cvt.rna.tf32.f32``; a product of
two tf32 values is exact in float32), and the same split is applied to the
plain attention at the widths of serving's call sites. Against the float32
plain version (``ops/cuda/flash_attention.py::flash_attention_reference``)
3xTF32 stays within ``TOL["float32"] = 5e-5`` of ``chip_smoke.py``
(relative to the largest output), and one tf32 product (1xTF32) does not:
so the kernel needs the split to keep serving's "TF32 off" accuracy.
"""

import numpy as np
import pytest
import torch

from object_detection_destr_tpu_torch.ops.attention import NEG_INF
from object_detection_destr_tpu_torch.ops.cuda.flash_attention import flash_attention_reference

TOL_FLOAT32 = 5e-5  # chip_smoke.py's TOL["float32"], which the kernel is held to on the card

# (heads, d, dv) of the serving call sites (encoder and decoder self-attention,
# the merged cross-attention) and of the hidden-512 cross-attention
SITES = [(8, 32, 32), (8, 64, 64), (1, 512, 256), (1, 1024, 512)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32, as the bits of a float32: add half an ulp of
    tf32 to the magnitude and clear the 13 low bits."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _attention(q, k, v, mask, matmul):
    logits = matmul(q, k.transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    return matmul(torch.softmax(logits, dim=-1), v)


def _case(h, d, dv, seed=0, b=2, sq=24, sk=40):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, w)).astype(np.float32))
               for s, w in ((sq, d), (sk, d), (sk, dv)))
    mask = torch.from_numpy(np.arange(sk)[None, :] < np.array([[sk * 3 // 4], [sk]]))
    ref, _ = flash_attention_reference(q, k, v, mask)
    return q, k, v, mask, ref


def _rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2**-11, one + 2**-12, one + 3 * 2**-11, -(one + 2**-11), 3.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + 2**-10, one, one + 2**-9, -(one + 2**-10), 3.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert (tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF == 0).all()  # 10 mantissa bits left


@pytest.mark.parametrize("h,d,dv", SITES)
def test_3xtf32_stays_within_the_float32_tolerance(h, d, dv):
    q, k, v, mask, ref = _case(h, d, dv)
    err = _rel_err(_attention(q, k, v, mask, matmul_3xtf32), ref)
    assert err <= TOL_FLOAT32, err
    assert err <= 1e-5, err  # about float32's own rounding, far inside the tolerance


@pytest.mark.parametrize("h,d,dv", SITES)
def test_1xtf32_exceeds_the_float32_tolerance(h, d, dv):
    q, k, v, mask, ref = _case(h, d, dv)
    assert _rel_err(_attention(q, k, v, mask, matmul_1xtf32), ref) > TOL_FLOAT32
