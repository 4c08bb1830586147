"""One side of a parent / change comparison on one card: run from the root
of a tree (a checkout of either commit), it runs that tree's chip_smoke.py
phases 6a at hidden 256 (captured step against eager), 6b (the validation
sweep), 8 (serving) and 12 (SSD's captured step) and prints one line
``AB {json}`` with their end-to-end numbers. artifacts/port_ab_r1/run.sh
calls it in turns."""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
           auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
           fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]
cs.phase_device(torch)
cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, auction.LIBRARY])
out = {"tree": os.path.basename(os.getcwd())}
cap = cs.phase_captured_train(torch, kernels, cs.destr_capture_setup(torch, 0, []), (18, 18, 0, 0, 1, 0), "hidden 256")
out["captured_ms"], out["eager_ms"] = cap["captured_ms"], cap["eager_ms"]
torch.cuda.empty_cache()
_, timing = cs.phase_validation(torch, kernels, 0)
out["val_images_per_sec"] = timing["val_images_per_sec"]
torch.cuda.empty_cache()
gen = torch.Generator().manual_seed(0)
images = [torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8).numpy() for h, w in cs.REQUEST_SIZES]
service, variables, launches, serve_timing, forward_ms = cs.phase_serving(torch, fa.flash_attention_fwd, 0, images)
out["request_ms"], out["request_eager_ms"] = serve_timing["captured_ms"], serve_timing["eager_ms"]
del service, variables
torch.cuda.empty_cache()
ssd = cs.phase_ssd_train(torch, kernels, 0)
out["ssd_captured_ms"] = ssd["captured_ms"]
print("AB " + json.dumps(out), flush=True)
