"""The port's flash attention with dropout, forward and backward, against
``jax.vjp`` of the JAX package's Pallas ``flash_attention_packed`` (interpret
mode on the CPU, as tests/test_pallas.py runs it).

On the CPU the port's autograd Function runs the CUDA kernels' plain
versions: ``flash_attention_packed_reference`` with an explicit keep mask and
the written-out ``flash_attention_packed_backward_reference``. Both sides are
fed the same keep mask: the JAX package's interpret-mode
``dropout_keep_mask(seed, b*h, sq_pad, sk_pad, rate)`` sliced to (Sq, Sk).

Tolerance: 1e-5 of each reference tensor's largest absolute value, float32
(both sides accumulate in float32; only the summation order differs).

Fully masked row: for a batch entry whose keys are all masked, the Pallas
backward is not the gradient of its own forward. Its float32 logsumexp,
-1e9 + log(Sk), rounds to -1e9, so the probabilities it recomputes are 1
instead of 1/Sk (dV comes out Sk times too large), and it passes
ds = p (dp - delta) through the masked logits, which are the constant -1e9
in the forward (dQ, dK nonzero). The port gives the gradient of its forward
there: dQ = dK = 0 and dV = sum(dO) / Sk, checked against autograd of the
plain forward.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _plan_packed,
    dropout_keep_mask,
    flash_attention_packed as jax_flash_attention_packed,
)
from object_detection_destr_tpu_torch.ops.cuda.flash_attention import (  # noqa: E402
    flash_attention_packed,
    flash_attention_packed_backward_reference,
    flash_attention_packed_reference,
)

TOL = 1e-5
BLOCK_Q, BLOCK_K = 8, 128

CASES = {
    # encoder-like: several heads, ragged key mask
    "encoder": dict(b=2, sq=24, sk=24, h=4, d=8, dv=8, masked_rows={0: 17}),
    # decoder self-attention: no mask
    "decoder": dict(b=2, sq=20, sk=20, h=4, d=16, dv=16, masked_rows=None),
    # merged cross-attention: one head, dv != d, Sq != Sk, masked
    "cross": dict(b=2, sq=18, sk=30, h=1, d=16, dv=8, masked_rows={1: 9}),
    # batch entry 1 has every key masked (Sk = the Pallas 128-key tile)
    "fully_masked_row": dict(b=2, sq=8, sk=128, h=2, d=8, dv=8, masked_rows={1: 0}),
}


def _case(b, sq, sk, h, d, dv, masked_rows, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h * d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h * d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h * dv)).astype(np.float32)
    dout = rng.normal(size=(b, sq, h * dv)).astype(np.float32)
    mask = None
    if masked_rows is not None:
        mask = np.ones((b, sk), bool)
        for i, valid in masked_rows.items():
            mask[i, valid:] = False
    return q, k, v, dout, mask


def _jax_keep(seed, b, h, sq, sk, rate):
    _, _, sq_pad, sk_pad = _plan_packed(sq, sk, BLOCK_Q, BLOCK_K, 4)
    keep = np.asarray(dropout_keep_mask(seed, b * h, sq_pad, sk_pad, rate))
    return keep.reshape(b, h, sq_pad, sk_pad)[:, :, :sq, :sk] > 0


def _close(ours, ref, name):
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(ours - ref).max() / scale
    assert err <= TOL, f"{name}: relative error {err:.2e}"


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_matches_pallas_vjp(name, rate):
    c = CASES[name]
    b, sq, sk, h = c["b"], c["sq"], c["sk"], c["h"]
    q, k, v, dout, mask = _case(**c, seed=sorted(CASES).index(name))
    seed = 11
    jmask = None if mask is None else jnp.asarray(mask)

    def jax_fn(q_, k_, v_):
        return jax_flash_attention_packed(
            q_, k_, v_, h, jmask, seed if rate else None, rate, None, BLOCK_Q, BLOCK_K, True
        )

    ref_out, pullback = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_dq, ref_dk, ref_dv = (np.asarray(g) for g in pullback(jnp.asarray(dout)))
    keep = torch.from_numpy(_jax_keep(seed, b, h, sq, sk, rate)) if rate else None

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = flash_attention_packed(tq, tk, tv, h, tm, dropout_rate=rate, keep_mask=keep)
    out.backward(torch.from_numpy(dout))
    _close(out.detach().numpy(), np.asarray(ref_out), "out")

    # the autograd Function ran the two plain versions
    plain_out, lse = flash_attention_packed_reference(tq.detach(), tk.detach(), tv.detach(), h, tm,
                                                      dropout_rate=rate, keep_mask=keep)
    np.testing.assert_array_equal(out.detach().numpy(), plain_out.numpy())
    grads = flash_attention_packed_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), h, tm, plain_out, lse, torch.from_numpy(dout),
        dropout_rate=rate, keep_mask=keep,
    )
    for g, t in zip(grads, (tq, tk, tv)):
        np.testing.assert_array_equal(g.numpy(), t.grad.numpy())

    ours = [t.grad.numpy() for t in (tq, tk, tv)]
    live = slice(None) if name != "fully_masked_row" else slice(0, 1)
    for g, ref, label in zip(ours, (ref_dq, ref_dk, ref_dv), ("dq", "dk", "dv")):
        _close(g[live], ref[live], label)
    if name == "fully_masked_row":
        assert not ours[0][1:].any() and not ours[1][1:].any()
        # each query's uniform weights 1/Sk (rate 0) or keep/(0.7 Sk)
        weights = np.ones((h, sq, sk)) if keep is None else keep[1].numpy() / (1.0 - rate)
        want = np.einsum("hqk,qhd->khd", weights / sk, dout[1].reshape(sq, h, -1)).reshape(sk, -1)
        _close(ours[2][1], want, "dv (fully masked)")
        _close(ref_dv[1] / sk, want, "JAX dv (fully masked) / Sk")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_is_the_gradient_of_the_plain_forward(name):
    """Autograd of the plain forward (a fixed keep mask, rate 0.3) equals the
    written-out plain backward, fully masked rows included."""
    c = CASES[name]
    b, sq, sk, h = c["b"], c["sq"], c["sk"], c["h"]
    q, k, v, dout, mask = _case(**c, seed=10 + sorted(CASES).index(name))
    keep = torch.from_numpy(np.random.default_rng(5).uniform(size=(b, h, sq, sk)) >= 0.3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention_packed_reference(tq, tk, tv, h, tm, dropout_rate=0.3, keep_mask=keep)
    out.backward(torch.from_numpy(dout))
    grads = flash_attention_packed_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), h, tm, out.detach(), lse.detach(),
        torch.from_numpy(dout), dropout_rate=0.3, keep_mask=keep,
    )
    for g, t, label in zip(grads, (tq, tk, tv), ("dq", "dk", "dv")):
        _close(g.numpy(), t.grad.numpy(), label)
