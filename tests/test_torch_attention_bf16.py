"""bfloat16 parity of the port's attention with the JAX package's.

Both packages round the attention probabilities (after dropout) to the
operand dtype before P V and sum in float32: the JAX package in
``ops/attention.py::scaled_dot_product_attention`` (l.93-96) and in the
Pallas forward (``_fwd_kernel_packed`` l.638-641, run here in interpret
mode, as tests/test_torch_attention.py runs it); the port in
``ops/attention.py::scaled_dot_product_attention`` and in the plain version
of its flash forward, ``flash_attention_packed_reference`` (which the
bfloat16 tensor-core kernel is held against on the card).

Tolerances, in bf16 ulps (2^-7 of the binade, 8 significant bits):
* the port's ``scaled_dot_product_attention``, and the plain flash forwards
  ``flash_attention_packed_reference`` / ``flash_attention_reference``
  (their ``_attention``), against JAX's ``scaled_dot_product_attention``:
  all round P at the same point and differ only in float32 summation order,
  so every element is within 1 ulp of its own magnitude (without the
  rounding of P, a third of the outputs differed, up to hundreds or
  thousands of ulps of near-zero ones);
* the flash forward against the Pallas kernel: within 2 ulps of the largest
  output. Pallas rounds the unnormalised p of its 128-key tile, the plain
  version the normalised p, so the two roundings differ by up to 2^-9 of
  each probability.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.ops.attention import (  # noqa: E402
    scaled_dot_product_attention as jax_sdpa,
)
from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    flash_attention_packed as jax_flash_attention_packed,
)
from object_detection_destr_tpu_torch.ops.attention import scaled_dot_product_attention  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda.flash_attention import (  # noqa: E402
    flash_attention_packed_reference,
    flash_attention_reference,
)

CASES = {
    # the self-attentions' geometry: several heads
    "heads": dict(b=2, sq=24, sk=40, h=4, d=16, dv=16, lengths=None),
    # the cross-attention's: one head, dv != d, a ragged key mask
    "single_head_ragged": dict(b=2, sq=12, sk=30, h=1, d=32, dv=16, lengths=(30, 9)),
}


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x).astype(np.float32), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _case(b, sq, sk, h, d, dv, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h * d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h * d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h * dv)).astype(np.float32)
    mask = np.ones((b, sk), bool)
    for i, n in enumerate(lengths or ()):
        mask[i, n:] = False
    return q, k, v, mask


def _bf16_torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _bf16_jax(a):
    return jnp.asarray(a, jnp.bfloat16)


def _as_f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_matches_pallas_in_bf16(name):
    c = CASES[name]
    q, k, v, mask = _case(**c, seed=sorted(CASES).index(name))
    ref = jax_flash_attention_packed(_bf16_jax(q), _bf16_jax(k), _bf16_jax(v), c["h"], jnp.asarray(mask),
                                     None, 0.0, None, 8, 128, True)
    out, _ = flash_attention_packed_reference(_bf16_torch(q), _bf16_torch(k), _bf16_torch(v), c["h"],
                                              torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    ref, out = _as_f32(ref), _as_f32(out)
    assert np.abs(out - ref).max() <= 2 * _ulp(np.abs(ref).max()), name


def _heads(a, h, w):  # (B, S, h*w) -> (B, h, S, w)
    return np.ascontiguousarray(a.reshape(a.shape[0], -1, h, w).transpose(0, 2, 1, 3))


def _jax_sdpa_case(name, seed):
    """A case's bf16 inputs (packed) and JAX's ``scaled_dot_product_attention``
    of them, taken on the head-major rearrangement: (B, Sq, h*dv)."""
    c = CASES[name]
    h, d, dv = c["h"], c["d"], c["dv"]
    q, k, v, mask = _case(**c, seed=seed)
    ref = jax_sdpa(_bf16_jax(_heads(q, h, d)), _bf16_jax(_heads(k, h, d)), _bf16_jax(_heads(v, h, dv)),
                   key_valid_mask=jnp.asarray(mask))
    return (q, k, v, mask), _as_f32(ref)


def _assert_within_own_ulp(name, out, ref):
    diff = np.abs(out - ref)
    assert np.all(diff <= _ulp(ref)), (
        f"{name}: {int((diff > 0).sum())} of {diff.size} outputs differ, by up to {diff.max():.3g} "
        f"({diff.max() / _ulp(np.abs(ref).max()):.3g} ulps of the largest output, "
        f"{(diff / _ulp(ref)).max():.3g} ulps of their own)")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sdpa_rounds_probabilities_as_jax_does(name):
    c = CASES[name]
    h, d, dv = c["h"], c["d"], c["dv"]
    (q, k, v, mask), ref = _jax_sdpa_case(name, seed=10 + sorted(CASES).index(name))
    out = scaled_dot_product_attention(_bf16_torch(_heads(q, h, d)), _bf16_torch(_heads(k, h, d)),
                                       _bf16_torch(_heads(v, h, dv)), key_valid_mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    _assert_within_own_ulp(name, _as_f32(out), ref)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_reference_rounds_probabilities_as_jax_does(name, layout):
    """The plain version #1 (packed) and #5 (head-major) are held against on
    the card, per element, against JAX's XLA attention on the same bf16
    inputs."""
    c = CASES[name]
    b, sq, h, d, dv = c["b"], c["sq"], c["h"], c["d"], c["dv"]
    (q, k, v, mask), ref = _jax_sdpa_case(name, seed=20 + sorted(CASES).index(name))
    if layout == "packed":
        out, _ = flash_attention_packed_reference(_bf16_torch(q), _bf16_torch(k), _bf16_torch(v), h,
                                                  torch.from_numpy(mask))
    else:
        out, _ = flash_attention_reference(_bf16_torch(_heads(q, h, d)), _bf16_torch(_heads(k, h, d)),
                                           _bf16_torch(_heads(v, h, dv)), torch.from_numpy(mask))
        out = out.transpose(1, 2).reshape(b, sq, h * dv)
    assert out.dtype == torch.bfloat16
    _assert_within_own_ulp(f"{name}/{layout}", _as_f32(out), ref)
