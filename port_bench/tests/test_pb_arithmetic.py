"""The operation counts and roofline arithmetic on a small configuration."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.harness import roofline
from port_bench.reference import steps
from port_bench.reference.weights import seeded_weights
from port_bench.tests.tiny import TINY_MODEL, tiny_cell


def _model_cfg():
    return tiny_cell("train-coco-800").config["model"]


def test_attention_bound_by_hand():
    site = {"b": 2, "sq": 100, "sk": 120, "h": 4, "d": 8, "dv": 8, "masked": True, "itemsize": 2}
    flops = 2 * 2 * 4 * 100 * 120 * 16
    nbytes = 2 * (2 * 100 * 32 + 2 * 120 * 32 * 2 + 2 * 100 * 32) + 4 * 2 * 4 * 100 + 2 * 120
    expect = max(nbytes / roofline.HBM_RATE, flops / roofline.BF16_PEAK)
    assert abs(roofline.attention_bound_s(site, "bfloat16", False) - expect) < 1e-18
    big = dict(site, sq=7056, sk=7056, d=32, dv=32)
    fwd = roofline.attention_bound_s(big, "bfloat16", False)
    both = roofline.attention_bound_s(big, "bfloat16", True)
    assert abs(fwd - 2 * 2 * 4 * 7056**2 * 64 / roofline.BF16_PEAK) / fwd < 1e-12  # operations bound it
    assert abs(both - fwd - 2 * 2 * 4 * 7056**2 * 160 / roofline.BF16_PEAK) / both < 1e-12
    assert roofline.attention_bound_s(big, "float32", False) == fwd * roofline.BF16_PEAK / roofline.TF32_PEAK


def test_attention_sites_of_a_forward():
    sites = steps.attention_work(_model_cfg(), 2, 64, "bfloat16")
    blocks = TINY_MODEL["num_encoder_blocks"] + 2 * TINY_MODEL["num_decoder_blocks"]
    assert len(sites) == blocks
    enc = sites[0]
    assert (enc["sq"], enc["sk"], enc["h"], enc["d"], enc["masked"]) == (4, 4, 4, 8, True)
    cross = sites[-1]  # one launch for both branches: 2 x k query rows, one head of 2C, values of C
    k = min(TINY_MODEL["top_k"], enc["sk"])
    assert (cross["sq"], cross["h"], cross["d"], cross["dv"]) == (2 * k, 1, 64, 32)
    assert all(s["itemsize"] == 2 for s in sites)


def test_meta_flops_equal_a_real_forwards():
    cfg = _model_cfg()
    counted = steps.model_flops(cfg, 1, 64, backward=False)
    model = steps.build_model(cfg, "float32", "cpu")
    seeded_weights(model, 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros((1, 64, 64, 3)), torch.ones((1, 64, 64), dtype=torch.bool))
    assert counted == counter.get_total_flops() > 0
    both = steps.model_flops(cfg, 1, 64, backward=True)
    assert 2.5 * counted < both < 3.5 * counted  # a backward is about twice its forward
