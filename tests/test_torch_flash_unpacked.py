"""The port's head-major flash attention, ``flash_attention`` and
``flash_attention_trainable`` on (B, h, S, d) operands (kernels #5 forward,
#6 dQ and #7 dK / dV; on the CPU their plain versions), against the JAX
package's ``flash_attention`` / ``flash_attention_trainable`` in interpret
mode, and the fully masked row of both packages.

Both sides get the same inputs (numpy, seeded) and, with dropout, the same
keep mask: the JAX package's interpret-mode ``dropout_keep_mask`` drawn at the
padded shape of its unpacked plan (``_plan``, not ``_plan_packed``) and
sliced to (Sq, Sk). Tolerance: 1e-5 of each reference tensor's largest
absolute value, float32, as in tests/test_torch_flash_two_pass.py (both sides
accumulate in float32; only the summation order differs).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa  # noqa: E402
from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _plan,
    dropout_keep_mask,
)
from object_detection_destr_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    flash_attention_packed as jax_flash_packed,
)
from object_detection_destr_tpu.ops.pallas.flash_attention import (  # noqa: E402
    flash_attention_trainable as jax_flash_trainable,
)
from object_detection_destr_tpu_torch.ops import flash_attention, flash_attention_trainable  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

TOL = 1e-5
BLOCK_Q, BLOCK_K = 8, 128

CASES = {
    # encoder self-attention: several heads, ragged key mask
    "encoder": dict(b=2, h=4, sq=24, sk=24, d=8, dv=8, valid={0: 17}),
    # decoder self-attention: no mask
    "decoder": dict(b=2, h=2, sq=20, sk=20, d=16, dv=16, valid=None),
    # the merged cross-attention: one head, dv != d, Sq != Sk, ragged mask
    "cross": dict(b=2, h=1, sq=24, sk=40, d=40, dv=24, valid={1: 23}),
}


def _case(b, h, sq, sk, d, dv, valid, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, dv)).astype(np.float32)
    dout = rng.normal(size=(b, h, sq, dv)).astype(np.float32)
    mask = None
    if valid is not None:
        mask = np.ones((b, sk), bool)
        for i, n in valid.items():
            mask[i, n:] = False
    return q, k, v, dout, mask


def _jax_keep(seed, b, h, sq, sk, rate):
    """The keep mask interpret mode feeds _fwd_kernel: drawn at the padded
    shape of the unpacked plan (float32), then sliced."""
    _, _, sq_pad, sk_pad = _plan(sq, sk, BLOCK_Q, BLOCK_K, 4)
    keep = np.asarray(dropout_keep_mask(seed, b * h, sq_pad, sk_pad, rate))
    return torch.from_numpy(keep.reshape(b, h, sq_pad, sk_pad)[:, :, :sq, :sk] > 0)


def _close(ours, ref, name):
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(ours - ref).max() / scale
    assert err <= TOL, f"{name}: relative error {err:.2e}"


def _jax_kwargs():
    return dict(block_q=BLOCK_Q, block_k=BLOCK_K, interpret=True)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name, rate):
    c = CASES[name]
    q, k, v, _, mask = _case(**c, seed=sorted(CASES).index(name))
    seed = 11
    jmask = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                               seed if rate else None, rate, **_jax_kwargs()))
    keep = _jax_keep(seed, c["b"], c["h"], c["sq"], c["sk"], rate) if rate else None
    tm = None if mask is None else torch.from_numpy(mask)
    ours = flash_attention(*map(torch.from_numpy, (q, k, v)), tm, dropout_rate=rate, keep_mask=keep)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    _close(ours.numpy(), ref, "out")


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name, rate):
    c = CASES[name]
    q, k, v, dout, mask = _case(**c, seed=10 + sorted(CASES).index(name))
    seed = 5
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = seed if rate else None
    fn = lambda a, b_, c_: jax_flash_trainable(a, b_, c_, jmask, jseed, rate, None, BLOCK_Q, BLOCK_K, True)
    ref_out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    keep = _jax_keep(seed, c["b"], c["h"], c["sq"], c["sk"], rate) if rate else None
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = flash_attention_trainable(tq, tk, tv, tm, dropout_rate=rate, keep_mask=keep)
    _close(out.detach().numpy(), np.asarray(ref_out), "out")
    out.backward(torch.from_numpy(dout))
    for t, r, label in zip((tq, tk, tv), ref, ("dq", "dk", "dv")):
        _close(t.grad.numpy(), r, label)

    # the Function's backward is the two plain versions of #6 / #7
    args = (tq.detach(), tk.detach(), tv.detach(), tm, out.detach(),
            fa.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(), tm, None, rate, None, keep)[1],
            torch.from_numpy(dout), None, rate, None, keep)
    assert torch.equal(fa.flash_attention_unpacked_dq_reference(*args), tq.grad)
    dk, dv = fa.flash_attention_unpacked_dkv_reference(*args)
    assert torch.equal(dk, tk.grad) and torch.equal(dv, tv.grad)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_unpacked_and_packed_layouts_agree(rate):
    """One logical input in both layouts: the same Philox keep mask (counter
    b*h + head) and the same out, lse and gradients (the plain versions;
    chip_smoke.py holds the kernels #1/#3/#4 and #5/#6/#7 to bit equality)."""
    c = CASES["encoder"]
    b, h, sq, sk, dv = c["b"], c["h"], c["sq"], c["sk"], c["dv"]
    q, k, v, dout, mask = (torch.from_numpy(a) for a in _case(**c, seed=3))
    seed = 99 if rate else None
    pk = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], -1)
    out, lse = fa.flash_attention_reference(q, k, v, mask, None, rate, seed)
    p_out, p_lse = fa.flash_attention_packed_reference(pk(q), pk(k), pk(v), h, mask, None, rate, seed)
    assert torch.equal(pk(out), p_out) and torch.equal(lse, p_lse)
    args = (q, k, v, mask, out, lse, dout, None, rate, seed)
    p_args = (pk(q), pk(k), pk(v), h, mask, p_out, p_lse, pk(dout), None, rate, seed)
    assert torch.equal(pk(fa.flash_attention_unpacked_dq_reference(*args)), fa.flash_attention_dq_reference(*p_args))
    for ours, packed in zip(fa.flash_attention_unpacked_dkv_reference(*args), fa.flash_attention_dkv_reference(*p_args)):
        assert torch.equal(pk(ours), packed)
    assert out.shape == (b, h, sq, dv) and lse.shape == (b, h, sq) and sk == k.shape[2]


def test_strided_views_and_dtypes():
    """A (B, S, h, d) tensor viewed as (B, h, S, d) gives what its contiguous
    copy gives; flash_attention builds no graph; gradients come in the
    operands' dtypes; dropout without a seed raises."""
    c = CASES["encoder"]
    q, k, v, dout, mask = (torch.from_numpy(a) if a is not None else None for a in _case(**c, seed=4))
    tm = mask
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(flash_attention(*views, tm), flash_attention(q, k, v, tm))
    leaf = q.clone().requires_grad_(True)
    assert not flash_attention(leaf, k, v, tm).requires_grad
    gq, gk, gv = (x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_trainable(gq, gk, gv, tm, 7, 0.3)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert gq.grad.dtype == gk.grad.dtype == gv.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, tm, dropout_rate=0.3)
    # scale defaults to 1/sqrt(d)
    d = q.shape[-1]
    assert torch.equal(flash_attention(q, k, v, tm, scale=d**-0.5), flash_attention(q, k, v, tm))


@pytest.mark.parametrize("name", ["flash_attention_unpacked_fwd", "flash_attention_unpacked_dq",
                                  "flash_attention_unpacked_dkv"])
def test_unpacked_wrappers_take_cuda_tensors_only(name):
    kernel = getattr(fa, name)
    q, k, v, dout, _ = (torch.from_numpy(a) if a is not None else None for a in _case(**CASES["decoder"], seed=0))
    lse = torch.zeros(2, 2, 20)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        if name.endswith("fwd"):
            kernel(q, k, v)
        else:
            kernel(q, k, v, None, dout, lse, dout)
    assert kernel.launches == before


def test_fully_masked_row():
    """A batch entry whose Sk = 40 keys are all masked. The JAX package's
    Pallas kernels, packed and unpacked, give sum(v) / sk_pad: the 88 keys
    that pad Sk to the 128-key tile weigh like the real ones (their logit is
    -1e9 too). Its XLA reference ops/attention.py gives mean(v) over the real
    keys, and so do the port's plain versions of #1 and #5 (and the kernels,
    which leave keys past Sk out entirely)."""
    b, h, sq, sk, d = 2, 2, 8, 40, 8
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (sq, sk, sk))
    mask = np.ones((b, sk), bool)
    mask[1] = False
    _, _, _, sk_pad = _plan(sq, sk, BLOCK_Q, BLOCK_K, 4)
    assert sk_pad == 128
    mean_v, padded_v = v[1].mean(axis=1), v[1].sum(axis=1) / sk_pad  # (h, d)
    expect = lambda x, target: np.abs(x[1] - target[:, None, :]).max()

    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    unpacked = np.asarray(jax_flash(jq, jk, jv, jm, **_jax_kwargs()))
    pk = lambda x: x.transpose(0, 2, 1, 3).reshape(b, x.shape[2], h * d)
    packed = np.asarray(jax_flash_packed(jnp.asarray(pk(q)), jnp.asarray(pk(k)), jnp.asarray(pk(v)), h, jm,
                                         block_q=BLOCK_Q, block_k=BLOCK_K, interpret=True))
    packed = packed.reshape(b, sq, h, d).transpose(0, 2, 1, 3)
    xla = np.asarray(jax_sdpa(jq, jk, jv, key_valid_mask=jm)).reshape(b, sq, h, d).transpose(0, 2, 1, 3)
    assert expect(unpacked, padded_v) <= 1e-6 and expect(packed, padded_v) <= 1e-6
    assert expect(unpacked, mean_v) > 1e-2  # the padded keys pull it away from mean(v)
    assert expect(xla, mean_v) <= 1e-6

    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    out5, _ = fa.flash_attention_reference(tq, tk, tv, tm)
    out1, _ = fa.flash_attention_packed_reference(*(torch.from_numpy(pk(x)) for x in (q, k, v)), h, tm)
    out1 = out1.view(b, sq, h, d).transpose(1, 2)
    assert expect(out5.numpy(), mean_v) <= 1e-6 and expect(out1.numpy(), mean_v) <= 1e-6
    # the other batch entry agrees everywhere
    _close(out5[0].numpy(), unpacked[0], "live entry")
