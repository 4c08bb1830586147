"""chip_smoke.py's phase 21 alone: BASELINE.json's config 1 (coco-ssd-300:
SSD300 over COCO's 80 classes with the SSD trainer's defaults, B=12, 300 px,
bf16) on a COCO-layout tree written from the seed, trained, captured,
evaluated, batch-inferred and served through the port's entry points. SSD
launches none of the nine CUDA kernels, so nothing is built.

    python3 artifacts/port_ssd_coco_r1/c1_21.py   # on a machine with one H100
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
           auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
           fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]
t0 = time.perf_counter()
card = cs.phase_device(torch)
out = cs.phase_config1(torch, kernels, 0, card)
cs.log(f"phase 21 {out['seconds']:.1f} s; all {time.perf_counter() - t0:.1f} s ({card})")
