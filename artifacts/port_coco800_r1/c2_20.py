"""chip_smoke.py's phase 20 alone: BASELINE.json's config 2 (coco-800:
DESTR-R50 over COCO's 80 classes at 800 px, B=8, bf16) on a COCO-layout tree
written from the seed, trained, captured, evaluated, batch-inferred, served
and its batched bf16 forward timed through the port's entry points, with
#1, #2 and #9 at the path's shapes against their plain versions.

    python3 artifacts/port_coco800_r1/c2_20.py   # on a machine with one H100
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
cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, auction.LIBRARY])
cs.log(f"build {time.perf_counter() - t0:.1f} s")
out = cs.phase_config2(torch, kernels, 0, card)
cs.log(f"phase 20 {out['seconds']:.1f} s; all {time.perf_counter() - t0:.1f} s ({card})")
