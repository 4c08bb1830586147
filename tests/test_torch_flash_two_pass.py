"""The two-pass flash-attention backward of the port (kernels #3 dQ and #4
dK / dV; on the CPU their plain versions ``flash_attention_dq_reference`` and
``flash_attention_dkv_reference``) against the JAX package's two-pass
backward, ``_bwd_impl_packed(..., fused=False, interpret=True)``, and the
choice between the fused and the two-pass backward (``backward_plan``).

Both sides get the same inputs and the same keep mask (the JAX package's
interpret-mode ``dropout_keep_mask``, sliced to (Sq, Sk), as
tests/test_torch_flash_backward.py feeds it); each side's backward takes its
own forward's out and lse. Tolerance: 1e-5 of each reference tensor's largest
absolute value, float32, as in tests/test_torch_flash_backward.py (both sides
accumulate in float32; only the summation order differs).

A fully masked row: the port's two-pass gradient is the gradient of its
forward (dQ = dK = 0, dV = sum(dO) / Sk), checked against autograd of the
plain forward; the Pallas kernels differ there (see
tests/test_torch_flash_backward.py), so those entries are left out of the
JAX comparison.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _bwd_impl_packed,
    _fwd_impl_packed,
    _plan_packed,
    dropout_keep_mask,
)
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

TOL = 1e-5
BLOCK_Q, BLOCK_K = 8, 128
H100_SMEM_OPTIN = 232448  # bytes of shared memory a block may opt in to on an H100

CASES = {
    # the merged cross-attention of a wide model, cut to size: one head wider
    # than 512 (past the fused kernel), dv != d, Sq != Sk, ragged key mask
    "wide_cross": dict(b=2, sq=24, sk=40, h=1, d=640, dv=320, masked_rows={1: 23}),
    # encoder-like: several heads, ragged key mask
    "encoder": dict(b=2, sq=24, sk=24, h=4, d=8, dv=8, masked_rows={0: 17}),
    # decoder self-attention: no mask
    "decoder": dict(b=2, sq=20, sk=20, h=4, d=16, dv=16, masked_rows=None),
    # batch entry 1 has every key masked
    "fully_masked_row": dict(b=2, sq=8, sk=36, h=2, d=8, dv=12, masked_rows={1: 0}),
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
def test_two_pass_plain_versions_match_pallas_two_pass(name, rate):
    c = CASES[name]
    b, sq, sk, h = c["b"], c["sq"], c["sk"], c["h"]
    q, k, v, dout, mask = _case(**c, seed=sorted(CASES).index(name))
    seed = 13
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, dout))
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = seed if rate else None
    jout, jlse = _fwd_impl_packed(jq, jk, jv, h, jmask, jseed, rate, None, BLOCK_Q, BLOCK_K, True)
    ref = [np.asarray(g) for g in _bwd_impl_packed(
        jq, jk, jv, h, jmask, jseed, jout, jlse, jdo, rate, None, BLOCK_Q, BLOCK_K, True, fused=False)]

    keep = torch.from_numpy(_jax_keep(seed, b, h, sq, sk, rate)) if rate else None
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_attention_packed_reference(tq, tk, tv, h, tm, dropout_rate=rate, keep_mask=keep)
    args = (tq, tk, tv, h, tm, out, lse, tdo, None, rate, None, keep)
    dq = fa.flash_attention_dq_reference(*args)
    dk, dv = fa.flash_attention_dkv_reference(*args)

    # the two plain versions split the fused plain version bit for bit
    for ours, fused in zip((dq, dk, dv), fa.flash_attention_packed_backward_reference(*args)):
        assert torch.equal(ours, fused)
    live = slice(None) if name != "fully_masked_row" else slice(0, 1)
    for g, r, label in zip((dq, dk, dv), ref, ("dq", "dk", "dv")):
        _close(g.numpy()[live], r[live], label)

    # and the autograd Function takes them when asked for the two-pass backward
    gq, gk, gv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    fa.flash_attention_packed(gq, gk, gv, h, tm, dropout_rate=rate, keep_mask=keep, fused=False).backward(tdo)
    for ours, grad in zip((dq, dk, dv), (gq, gk, gv)):
        assert torch.equal(ours, grad.grad)


def test_fully_masked_row_is_the_gradient_of_the_plain_forward():
    """Autograd of the plain forward (a fixed keep mask, rate 0.3) equals the
    two-pass plain backward, the fully masked batch entry included."""
    c = CASES["fully_masked_row"]
    b, sq, sk, h = c["b"], c["sq"], c["sk"], c["h"]
    q, k, v, dout, mask = _case(**c, seed=21)
    keep = torch.from_numpy(np.random.default_rng(5).uniform(size=(b, h, sq, sk)) >= 0.3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tm, tdo = torch.from_numpy(mask), torch.from_numpy(dout)
    out, lse = fa.flash_attention_packed_reference(tq, tk, tv, h, tm, dropout_rate=0.3, keep_mask=keep)
    out.backward(tdo)
    args = (tq.detach(), tk.detach(), tv.detach(), h, tm, out.detach(), lse.detach(), tdo, None, 0.3, None, keep)
    grads = (fa.flash_attention_dq_reference(*args), *fa.flash_attention_dkv_reference(*args))
    for g, t, label in zip(grads, (tq, tk, tv), ("dq", "dk", "dv")):
        _close(g.numpy(), t.grad.numpy(), label)
    assert not grads[0][1].any() and not grads[1][1].any()


@pytest.mark.parametrize("d,dv,dtype,plan", [
    (32, 32, torch.float32, "fused"),
    (32, 32, torch.bfloat16, "fused"),
    (64, 64, torch.float32, "fused"),
    (64, 64, torch.bfloat16, "fused"),
    (128, 128, torch.bfloat16, "fused"),  # decoder self-attention at hidden 512
    (512, 256, torch.float32, "fused"),  # the cross-attention at hidden 256: 223,360 bytes
    (512, 256, torch.bfloat16, "fused"),
    (1024, 512, torch.float32, "two_pass"),  # the cross-attention at hidden 512: 444,544 bytes
    (1024, 512, torch.bfloat16, "two_pass"),  # 407,936 bytes
    (1024, 16, torch.bfloat16, "two_pass"),  # fits, but wider than the fused kernel dispatches
])
def test_backward_plan(d, dv, dtype, plan):
    assert fa.backward_plan(d, dv, dtype, H100_SMEM_OPTIN) == plan
    # the plain versions on the CPU check the width only
    assert fa.backward_plan(d, dv, dtype) == ("fused" if max(d, dv) <= 512 else "two_pass")


def test_fused_smem_bytes_grow_with_the_widths():
    """The mirror of the fused kernel's shared-memory layout (chip_smoke.py
    holds it against the library's own count on the card): float32's
    CUDA-core layout, and bfloat16's tensor-core layout, whose dK / dV
    accumulators move from registers to shared memory past d + dv = 256."""
    assert fa.fused_backward_smem_bytes(512, 256, 4) == 223360
    assert fa.fused_backward_smem_bytes(512, 256, 4) <= H100_SMEM_OPTIN < fa.fused_backward_smem_bytes(512, 512, 4)
    bf16 = [fa.fused_backward_smem_bytes(d, dv, 2) for d, dv in [(32, 32), (64, 64), (128, 128), (512, 256)]]
    assert bf16 == [45184, 65664, 106624, 211328]
    assert bf16[-1] <= H100_SMEM_OPTIN < fa.fused_backward_smem_bytes(512, 512, 2) == 276864


def test_fused_true_raises_where_the_fused_backward_cannot_run():
    c = CASES["wide_cross"]
    q, k, v, dout, mask = _case(**c, seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention_packed(tq, tk, tv, 1, torch.from_numpy(mask), fused=True)
    with pytest.raises(ValueError, match="fused backward requested"):
        out.backward(torch.from_numpy(dout))


@pytest.mark.parametrize("name", ["flash_attention_dq", "flash_attention_dkv"])
def test_two_pass_wrappers_take_cuda_tensors_only(name):
    kernel = getattr(fa, name)
    q, k, v, dout, _ = (torch.from_numpy(a) if a is not None else None for a in _case(**CASES["decoder"], seed=0))
    lse = torch.zeros(2, 4, 20)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(q, k, v, 4, None, dout, lse, dout)
    assert kernel.launches == before
