"""chip_smoke.py's phase 19 alone: BASELINE.json's config 4
(train-1333-r101-dc5: DESTR-R101, dilated C5, 1333 px, B=1, bf16) trained,
captured, evaluated, served and profiled through the port's entry points.

    python3 artifacts/port_c4_r1/c4_19.py   # on a machine with one H100
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
out = cs.phase_config4(torch, kernels, 0, card)
cs.log("categories " + "; ".join(f"{r['name']} {r['ms_per_step']:.3f} ({r['count_per_step']:.1f})"
                                 for r in out["profile"]["categories"]))
cs.log(f"phase 19 {out['seconds']:.1f} s; all {time.perf_counter() - t0:.1f} s ({card})")
