"""Parity of the port's head-packed flash attention with the JAX package's
Pallas kernel (run in interpret mode on the CPU, as tests/test_pallas.py runs
it). On the CPU the port's wrapper runs its plain PyTorch version, which is
what the CUDA kernel is held against on the card.

Tolerance: 1e-5 of the reference output's largest absolute value, float32
(both sides accumulate in float32; only the summation order differs).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _fwd_impl_packed,
    flash_attention_packed as jax_flash_attention_packed,
)
from object_detection_destr_tpu_torch.ops.cuda.flash_attention import (  # noqa: E402
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_reference,
)
from torch_threads import one_torch_thread  # noqa: E402, F401

TOL = 1e-5


def _case(b, sq, sk, h, d, dv, masked_rows, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h * d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h * d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h * dv)).astype(np.float32)
    mask = np.ones((b, sk), bool)
    for i, valid in masked_rows.items():
        mask[i, valid:] = False
    return q, k, v, mask


CASES = {
    # h=4, d=8 with a ragged key mask
    "ragged_mask": dict(b=2, sq=24, sk=40, h=4, d=8, dv=8, masked_rows={0: 17}),
    # single head, dv != d, Sq != Sk (the cross-attention geometry)
    "single_head_dv": dict(b=2, sq=12, sk=30, h=1, d=16, dv=8, masked_rows={1: 9}),
    # batch row 1 has every key masked: its rows average over the Sk real
    # keys (Sk a multiple of the Pallas kernel's 128-key tile, so the JAX
    # side averages over exactly those keys too)
    "fully_masked_row": dict(b=2, sq=8, sk=128, h=2, d=8, dv=8, masked_rows={1: 0}),
    # heads past 1024: hidden 1024's cross-attention and an odd width
    "wider_2048": dict(b=1, sq=16, sk=24, h=1, d=2048, dv=1024, masked_rows={0: 19}),
    "wider_1040": dict(b=1, sq=12, sk=20, h=1, d=1040, dv=520, masked_rows={0: 13}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_pallas(name):
    c = CASES[name]
    q, k, v, mask = _case(**c, seed=sorted(CASES).index(name))
    h, sq = c["h"], c["sq"]

    ref_out = np.asarray(
        jax_flash_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, jnp.asarray(mask),
            None, 0.0, None, 8, 128, True,
        )
    )
    _, ref_lse = _fwd_impl_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, jnp.asarray(mask),
        None, 0.0, None, 8, 128, True,
    )
    ref_lse = np.asarray(ref_lse)[:, :sq, :h].transpose(0, 2, 1)  # (B, h, Sq)

    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    out = flash_attention_packed(tq, tk, tv, h, tm).numpy()
    plain_out, lse = flash_attention_packed_reference(tq, tk, tv, h, tm)
    np.testing.assert_array_equal(out, plain_out.numpy())  # CPU -> plain version

    scale = np.abs(ref_out).max()
    assert np.abs(out - ref_out).max() <= TOL * scale, name
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=TOL, atol=TOL * np.abs(ref_lse).max())
    if name == "fully_masked_row":
        # uniform weights over the real keys: the mean of V
        mean_v = v[1].reshape(c["sk"], h, c["dv"]).mean(0).reshape(-1)
        np.testing.assert_allclose(out[1], np.broadcast_to(mean_v, out[1].shape), atol=1e-5)


def test_wrapper_rules_on_cpu():
    q, k, v, mask = _case(b=1, sq=4, sk=6, h=2, d=4, dv=4, masked_rows={}, seed=7)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    # attention dropout runs (Philox from a seed), and needs the seed
    plain = flash_attention_packed(tq, tk, tv, 2, tm)
    dropped = flash_attention_packed(tq, tk, tv, 2, tm, dropout_rate=0.5, dropout_seed=3)
    assert dropped.shape == plain.shape and not torch.equal(dropped, plain)
    assert torch.equal(dropped, flash_attention_packed(tq, tk, tv, 2, tm, dropout_rate=0.5, dropout_seed=3))
    with pytest.raises(ValueError, match="seed"):
        flash_attention_packed(tq, tk, tv, 2, tm, dropout_rate=0.1)
    # the kernel wrapper itself takes only CUDA tensors and never falls back
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(tq, tk, tv, 2, tm)
    assert flash_attention_fwd.launches == before
