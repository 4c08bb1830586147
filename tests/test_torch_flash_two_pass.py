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

bfloat16 (the plain versions the card's bf16 kernels #3, #4, #6 and #7 are
held against): q, k, v and dO in bfloat16 through the packed pair and the
head-major pair against ``_bwd_impl_packed(..., fused=False,
interpret=True)`` and ``_bwd_impl``. Both sides get JAX's forward out and lse
and one keep mask, so only the order of the float32 sums differs before each
side rounds its gradient to bfloat16 once; the two roundings of nearly equal
float32 values differ by at most one bf16 ulp of the element, so the
tolerance is one bf16 ulp (2**(floor(log2 m) - 7)) of the reference's
largest absolute value m. A fully masked batch entry is checked against the
port's own rule (dQ = dK = 0, dV = (keep / (1 - rate) / Sk)^T dO).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _bwd_impl,
    _bwd_impl_packed,
    _fwd_impl,
    _fwd_impl_packed,
    _plan,
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


BF16_CASES = {
    # the wide cross-attention cut to size, a ragged entry, an unmasked one
    # and a fully masked one
    "wide_cross": dict(b=3, sq=24, sk=40, h=1, d=640, dv=320, masked_rows={0: 23, 2: 0}),
    # encoder-like: several narrow heads, ragged key mask
    "encoder": dict(b=2, sq=24, sk=24, h=4, d=8, dv=8, masked_rows={0: 17}),
}


def _bf16_ulp_close(ours, ref, name):
    m = float(np.abs(ref).max())
    ulp = 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0
    err = float(np.abs(ours - ref).max())
    assert err <= ulp, f"{name}: {err:.3e} off, one bf16 ulp of the largest value is {ulp:.3e}"


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_two_pass_plain_versions_match_pallas_in_bfloat16(name, layout, rate):
    c = BF16_CASES[name]
    b, sq, sk, h, d, dv = c["b"], c["sq"], c["sk"], c["h"], c["d"], c["dv"]
    q, k, v, dout, mask = _case(**c, seed=40 + sorted(BF16_CASES).index(name))
    if layout == "unpacked":  # the same logical inputs, head-major
        q, k, v, dout = (x.reshape(b, x.shape[1], h, -1).transpose(0, 2, 1, 3).copy() for x in (q, k, v, dout))
    seed = 17
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = seed if rate else None
    if layout == "packed":
        jout, jlse = _fwd_impl_packed(jq, jk, jv, h, jmask, jseed, rate, None, BLOCK_Q, BLOCK_K, True)
        ref = _bwd_impl_packed(jq, jk, jv, h, jmask, jseed, jout, jlse, jdo, rate, None, BLOCK_Q, BLOCK_K, True,
                               fused=False)
        _, _, sq_pad, sk_pad = _plan_packed(sq, sk, BLOCK_Q, BLOCK_K, 2)
    else:
        jout, jlse = _fwd_impl(jq, jk, jv, jmask, jseed, rate, None, BLOCK_Q, BLOCK_K, True)
        ref = _bwd_impl(jq, jk, jv, jmask, jseed, jout, jlse, jdo, rate, None, BLOCK_Q, BLOCK_K, True)
        _, _, sq_pad, sk_pad = _plan(sq, sk, BLOCK_Q, BLOCK_K, 2)
    assert all(g.dtype == jnp.bfloat16 for g in ref)
    ref = [_f32(g) for g in ref]
    keep = None
    if rate:  # the mask the Pallas kernels drew, at their bf16 plan's padded shape
        drawn = np.asarray(dropout_keep_mask(seed, b * h, sq_pad, sk_pad, rate))
        keep = torch.from_numpy(drawn.reshape(b, h, sq_pad, sk_pad)[:, :, :sq, :sk] > 0)

    bf = lambda x: torch.from_numpy(_f32(x)).to(torch.bfloat16)
    tq, tk, tv, tdo, tout = (bf(x) for x in (jq, jk, jv, jdo, jout))
    # JAX keeps lse lane-padded: (B, Sq_pad, lanes) with head hh in lane hh
    # (packed), or (B*h, Sq_pad, lanes) broadcast over the lanes (head-major)
    jlse = np.asarray(jlse, np.float32)
    lse = jlse[:, :sq, :h].transpose(0, 2, 1) if layout == "packed" else jlse[:, :sq, 0].reshape(b, h, sq)
    tlse = torch.from_numpy(np.ascontiguousarray(lse))
    tm = None if mask is None else torch.from_numpy(mask)
    if layout == "packed":
        args = (tq, tk, tv, h, tm, tout, tlse, tdo, None, rate, None, keep)
        grads = (fa.flash_attention_dq_reference(*args), *fa.flash_attention_dkv_reference(*args))
    else:
        args = (tq, tk, tv, tm, tout, tlse, tdo, None, rate, None, keep)
        grads = (fa.flash_attention_unpacked_dq_reference(*args), *fa.flash_attention_unpacked_dkv_reference(*args))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    grads = [g.float().numpy() for g in grads]

    full = [i for i, n in (c["masked_rows"] or {}).items() if n == 0]
    live = [i for i in range(b) if i not in full]
    for g, r, label in zip(grads, ref, ("dq", "dk", "dv")):
        _bf16_ulp_close(g[live], r[live], label)
    for i in full:  # the port's rule: its forward's gradient
        assert not grads[0][i].any() and not grads[1][i].any()
        w = np.full((h, sq, sk), 1.0 / sk) * (1.0 if keep is None else keep[i].numpy() / (1.0 - rate))
        do = _f32(jdo[i])
        if layout == "packed":
            want = np.einsum("hqk,qhe->khe", w, do.reshape(sq, h, dv)).reshape(sk, h * dv)
        else:
            want = np.einsum("hqk,hqe->hke", w, do)
        _bf16_ulp_close(grads[2][i], want, "dv of the fully masked entry")


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
