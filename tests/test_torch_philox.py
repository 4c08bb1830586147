"""The plain PyTorch Philox4x32-10 of the flash-attention dropout
(ops/cuda/flash_attention.py::philox_keep_bits, the bits csrc/philox.cuh
draws) against a pure-Python integer implementation of the same rounds, the
Python implementation against Random123's known-answer vectors, and the keep
rule at its threshold. Exact integer equality throughout."""

import numpy as np
import pytest
import torch

from object_detection_destr_tpu_torch.ops.cuda.flash_attention import (
    _keep_mask,
    dropout_threshold,
    philox_keep_bits,
)

M = 0xFFFFFFFF


def philox4x32_10(ctr, key):
    """Philox4x32-10 on Python integers (Salmon et al., SC 2011)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & M, p1 & M, ((p0 >> 32) ^ c3 ^ k1) & M, p0 & M
    return c0, c1, c2, c3


@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_python_philox_known_answers(ctr, key, expected):
    assert philox4x32_10(ctr, key) == expected


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 2])
def test_torch_philox_matches_integer_rounds(seed):
    rng = np.random.default_rng(seed % 1000)
    bh = rng.integers(0, 2**31, 64)
    q = rng.integers(0, 2**31, 64)
    k = rng.integers(0, 2**31, 64)
    q[:4], k[:4], bh[:4] = 0, 0, 0  # small coordinates as on the path
    ours = philox_keep_bits(seed, torch.from_numpy(bh), torch.from_numpy(q), torch.from_numpy(k))
    ref = [philox4x32_10((int(a), int(b), int(c), 0), (seed, 0))[0] for a, b, c in zip(q, k, bh)]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref, np.int64))


def test_keep_rule_threshold_boundary():
    for rate in (0.0, 0.1, 0.3, 0.5, 0.999999):
        thr = dropout_threshold(rate)
        assert thr == min(max(int(rate * 4294967296.0), 0), 4294967295)
        bits = torch.tensor([max(thr - 1, 0), thr, min(thr + 1, M), M], dtype=torch.int64)
        keep = (bits >= thr).tolist()
        assert keep == [thr == 0, True, True, True]
    assert dropout_threshold(0.3) == 1288490188
    assert dropout_threshold(1.5) == M  # clamped like _drop_threshold


def test_keep_mask_is_a_pure_function_of_coordinates():
    """The mask depends on (seed, b*h + head, q, k) only: a sub-block equals
    the same coordinates of the full mask (what lets the backward regenerate
    the forward's mask with other tiles), and the kept share is 1 - rate."""
    full = _keep_mask(7, 0.3, 2, 3, 40, 50, "cpu")
    part = philox_keep_bits(
        7, torch.arange(6).view(2, 3, 1, 1)[1:, 1:], torch.arange(10, 30).view(1, 1, 20, 1),
        torch.arange(5, 45).view(1, 1, 1, 40),
    ) >= dropout_threshold(0.3)
    assert torch.equal(full[1:, 1:, 10:30, 5:45], part)
    share = _keep_mask(3, 0.3, 4, 8, 128, 256, "cpu").float().mean().item()
    assert abs(share - 0.7) < 0.005
    assert not torch.equal(_keep_mask(3, 0.3, 1, 1, 8, 8, "cpu"), _keep_mask(4, 0.3, 1, 1, 8, 8, "cpu"))
