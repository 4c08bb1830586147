"""The dropout seeds a CUDA graph can replay: the flash kernels read their
seed from a one-element int64 tensor (ops/cuda/flash_attention.py,
csrc/philox.cuh) and the model's dropout stream (``DropoutRng``) is
reseeded from the step.

On the CPU the plain versions run: a seed given as a tensor draws exactly
the keep bits, outputs and gradients of the same seed given as an int (the
rule the kernels follow, held against ``philox_keep_bits`` on the card by
chip_smoke.py); two seeds draw two masks; a step's draws are a pure
function of (seed, step), so reseeding for a step draws them again and
another step draws others.
"""

import numpy as np
import pytest
import torch

from object_detection_destr_tpu_torch.config import DestrConfig
from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng, dropout
from object_detection_destr_tpu_torch.models.destr.model import build_destr
from object_detection_destr_tpu_torch.ops.cuda.flash_attention import (
    _keep_mask,
    flash_attention_packed,
    philox_keep_bits,
    seed_tensor,
)


def _qkv(seed=0, b=2, sq=5, sk=7, h=2, d=4):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_(True)
    return mk(b, sq, h * d), mk(b, sk, h * d), mk(b, sk, h * d)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, 2**32 + 5])
def test_tensor_seed_draws_the_int_seeds_bits(seed):
    bh, q, k = torch.arange(6).view(6, 1, 1), torch.arange(5).view(1, 5, 1), torch.arange(9).view(1, 1, 9)
    as_int = philox_keep_bits(seed, bh, q, k)
    as_tensor = philox_keep_bits(torch.tensor([seed], dtype=torch.int64), bh, q, k)
    assert torch.equal(as_int, as_tensor)
    assert torch.equal(_keep_mask(seed, 0.3, 2, 3, 5, 9, "cpu"),
                       _keep_mask(seed_tensor(seed, torch.device("cpu")), 0.3, 2, 3, 5, 9, "cpu"))
    assert int(seed_tensor(seed, torch.device("cpu"))) == seed & 0xFFFFFFFF


def test_seed_tensor_checks():
    cpu = torch.device("cpu")
    own = torch.tensor([3], dtype=torch.int64)
    assert seed_tensor(own, cpu).data_ptr() == own.data_ptr()  # read in place, not copied
    for bad in (torch.tensor([3], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int64)):
        with pytest.raises(ValueError, match="one int64 element"):
            seed_tensor(bad, cpu)


def test_flash_forward_and_backward_with_a_tensor_seed():
    """The differentiable op with a tensor seed equals the int seed (out and
    gradients), the backward regenerating the forward's mask; another seed
    draws another mask."""
    results = []
    for seed in (11, torch.tensor([11], dtype=torch.int64), 12):
        q, k, v = _qkv()
        out = flash_attention_packed(q, k, v, 2, dropout_rate=0.4, dropout_seed=seed)
        (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum().backward()
        results.append((out.detach(), q.grad, k.grad, v.grad))
    for a, b in zip(results[0], results[1]):
        assert torch.equal(a, b)
    assert not torch.equal(results[0][0], results[2][0])


def test_dropout_rng_is_a_function_of_the_step():
    rng = DropoutRng(3)
    draws = {}
    for step in (4, 5, 4):
        rng.begin_step(step)
        seed = rng.seed()
        assert seed.dtype == torch.int64 and seed.shape == (1,)
        draws.setdefault(step, []).append((seed, dropout(torch.ones(64), 0.5, rng)))
    (s4, d4), (s4b, d4b) = draws[4]
    (s5, d5), = draws[5]
    assert torch.equal(s4, s4b) and torch.equal(d4, d4b)
    assert not torch.equal(s4, s5) and not torch.equal(d4, d5)
    other = DropoutRng(4)
    other.begin_step(4)
    assert not torch.equal(other.seed(), s4)


def test_train_forward_redraws_per_step():
    cfg = DestrConfig(hidden_dim=32, ffn_dim=64, num_heads=4, num_encoder_blocks=1, num_decoder_blocks=1,
                      top_k=4, dropout=0.3)
    torch.manual_seed(0)
    model = build_destr(cfg, "cpu").train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32))
    rng = DropoutRng(0)
    outs = []
    for step in (2, 2, 3):
        rng.begin_step(step)
        with torch.no_grad():
            outs.append(model(x, train=True, rng=rng)[0]["pred_boxes"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
