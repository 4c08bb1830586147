"""The float32 flash backward on the tensor cores, on the CPU: the fused
kernel (``csrc/flash_attention_bwd.cu::flash_bwd_f32_kernel``, #2) and the
two-pass kernels (``csrc/flash_attention_bwd_two_pass.cu``:
``flash_two_pass_f32_kernel`` and, past d / 8 + dv / 8 = 192 k-steps,
``flash_two_pass_f32_wide_kernel``, #3 / #4 and head-major #6 / #7).

* Their precision argument: the kernels split every float32 operand of
  their five products (S = Q K^T, dP = dO V^T, dV = (P keep)^T dO, dK =
  dS^T Q, dQ = dS K) into tf32 halves by truncation
  (``tc::split_tf32_trunc``: big = x with its 13 low mantissa bits cleared,
  small = x - big, of which the tensor cores read the top 19 bits) and sum
  three tf32 products (3xTF32; ``tests/test_torch_tf32_split.py`` emulates
  the forward's rounding split). At the float32 training step's call sites
  of #2 and of #3 / #4 (hidden 512's and hidden 1024's merged
  cross-attention at their full head widths, short sequences), the
  emulated gradients stay within ``BWD_TOL["float32"] = 1e-4`` of
  ``chip_smoke.py`` (relative to each gradient's largest value) against the
  float32 ones, and one tf32 product (1xTF32) does not.
* Their names in a trace: ``chip_smoke.trace_launches`` (which reads a
  replayed step's launches) and ``tools/profile_step_torch.py`` (which sums
  a step's device time by kernel) count each as its kernel number, as they
  count the bfloat16 kernels.
"""

import os
import sys

import numpy as np
import pytest
import torch

from object_detection_destr_tpu_torch.ops.attention import NEG_INF

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from tests.test_torch_tf32_split import matmul_1xtf32  # noqa: E402
from tools.profile_step_torch import category  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

BWD_TOL_FLOAT32 = 1e-4  # chip_smoke.py's BWD_TOL["float32"], which the kernel is held to on the card

# (heads, d, dv, masked) of the float32 step's #2 sites: hidden 256's encoder
# self-attention, decoder self-attention and merged cross-attention, and
# hidden 512's decoder self-attention
SITES = [(8, 32, 32, True), (8, 64, 64, False), (1, 512, 256, True), (8, 128, 128, False)]
# (heads, d, dv, masked) of the float32 step's two-pass (#3 / #4) sites: the
# merged cross-attention at hidden 512 (the JPW-24 class) and at hidden 1024
# (the wide class)
TWO_PASS_SITES = [(1, 1024, 512, True), (1, 2048, 1024, True)]


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 truncated to tf32 (its 13 low bits cleared), as the kernel's
    big half and as the tensor cores read a float32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_3xtf32_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32_trunc(a), tf32_trunc(b)
    a_small, b_small = tf32_trunc(a - a_big), tf32_trunc(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def test_truncated_split_keeps_float32_to_2_to_the_minus_20():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    big = tf32_trunc(x)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    kept = big.double() + tf32_trunc(x - big).double()
    assert ((kept - x.double()).abs() <= 2.0**-20 * x.double().abs()).all()


def _gradients(q, k, v, dout, mask, matmul):
    """dQ, dK, dV of masked softmax attention with every product through
    ``matmul``, p recomputed from the float32 logsumexp as the kernel does."""
    scale = q.shape[-1] ** -0.5
    exact = torch.matmul
    logits = (exact(q, k.transpose(-1, -2)) * scale).masked_fill(~mask[:, None, None, :], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    out = exact(torch.exp(logits - lse), v)
    delta = (dout * out).sum(-1, keepdim=True)
    s = (matmul(q, k.transpose(-1, -2)) * scale).masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(s - lse)
    ds = p * (matmul(dout, v.transpose(-1, -2)) - delta) * scale
    ds = ds.masked_fill(~mask[:, None, None, :], 0.0)
    return matmul(ds, k), matmul(ds.transpose(-1, -2), q), matmul(p.transpose(-1, -2), dout)


def _case(h, d, dv, masked, seed=0, b=2, sq=40, sk=48):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((b, h, s, w)).astype(np.float32))
                     for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
    lengths = np.array([[sk * 3 // 4], [sk]]) if masked else np.array([[sk], [sk]])
    mask = torch.from_numpy(np.arange(sk)[None, :] < lengths)
    return q, k, v, dout, mask


def _worst(grads, ref):
    return max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(grads, ref))


@pytest.mark.parametrize("h,d,dv,masked", SITES + TWO_PASS_SITES)
def test_3xtf32_gradients_stay_within_the_float32_tolerance(h, d, dv, masked):
    q, k, v, dout, mask = _case(h, d, dv, masked)
    ref = _gradients(q, k, v, dout, mask, torch.matmul)
    err = _worst(_gradients(q, k, v, dout, mask, matmul_3xtf32_trunc), ref)
    assert err <= BWD_TOL_FLOAT32, err
    assert err <= 2e-5, err  # about float32's own rounding, inside the tolerance


@pytest.mark.parametrize("h,d,dv,masked", SITES + TWO_PASS_SITES)
def test_1xtf32_gradients_exceed_the_float32_tolerance(h, d, dv, masked):
    q, k, v, dout, mask = _case(h, d, dv, masked)
    ref = _gradients(q, k, v, dout, mask, torch.matmul)
    assert _worst(_gradients(q, k, v, dout, mask, matmul_1xtf32), ref) > BWD_TOL_FLOAT32


def test_tolerance_is_chip_smokes():
    assert chip_smoke.BWD_TOL["float32"] == BWD_TOL_FLOAT32


@pytest.mark.parametrize("name,index,label", [
    ("void (anonymous namespace)::flash_bwd_f32_kernel<8, 32>(const float *, ...)", 1, "flash_attention_bwd #2"),
    ("void (anonymous namespace)::flash_bwd_tc_kernel<64, 0, 32>(const __nv_bfloat16 *, ...)", 1,
     "flash_attention_bwd #2"),
    ("void (anonymous namespace)::flash_fwd_f32_kernel<128, false>(const float *, ...)", 0,
     "flash_attention_fwd #1/#5"),
    ("void (anonymous namespace)::flash_two_pass_f32_kernel<false, 24>((anonymous namespace)::Params)", 2,
     "flash_attention_dq #3/#6"),
    ("void (anonymous namespace)::flash_two_pass_f32_kernel<true, 24>((anonymous namespace)::Params)", 3,
     "flash_attention_dkv #4/#7"),
    ("void (anonymous namespace)::flash_two_pass_f32_wide_kernel<false>((anonymous namespace)::Params, int, int)",
     2, "flash_attention_dq #3/#6"),
    ("void (anonymous namespace)::flash_two_pass_f32_wide_kernel<true>((anonymous namespace)::Params, int, int)",
     3, "flash_attention_dkv #4/#7"),
    ("_ZN12_GLOBAL__N_125flash_two_pass_f32_kernelILb1ELi12EEEvNS_6ParamsE", 3, "flash_attention_dkv #4/#7"),
    ("void (anonymous namespace)::flash_two_pass_tc_kernel<false, 12>((anonymous namespace)::Params)", 2,
     "flash_attention_dq #3/#6"),
    ("void (anonymous namespace)::flash_two_pass_tc_wide_kernel<true>((anonymous namespace)::Params, int, int)", 3,
     "flash_attention_dkv #4/#7"),
])
def test_trace_names_count_each_kernel_once(name, index, label):
    counts = chip_smoke.trace_launches({name: 6})
    assert counts == [6 if i == index else 0 for i in range(len(counts))]
    assert category(name, "kernel") == label
