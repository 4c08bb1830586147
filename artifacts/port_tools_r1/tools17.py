"""chip_smoke.py's phase 17 alone, with what it reads: phase 6b's
checkpoints and phase 15 (d)'s profile trace; then each kernel of the
profile's convolution and GEMM categories with its ms and count a step.

    python3 artifacts/port_tools_r1/tools17.py   # on a machine with one H100
"""
import os
import shutil
import sys
import tempfile
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
ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
try:
    cs.phase_validation(torch, kernels, 0, ckpt)
    torch.cuda.empty_cache()
    prof = cs.profile_captured_step(torch, kernels, card)
    cs.log("categories " + "; ".join(f"{r['name']} {r['ms_per_step']:.3f} ({r['count_per_step']:.1f})" for r in prof["categories"]))
    cs.log("top " + "; ".join(f"{r['name'][:90]} {r['ms_per_step']:.3f} ({r['count_per_step']:.1f})" for r in prof["top"]))
    from object_detection_destr_tpu_torch.train.profiler import parse_trace
    tool = cs.repo_module("profile_step_torch", "tools/profile_step_torch.py")
    parsed = parse_trace(os.path.join(os.path.dirname(os.path.abspath(cs.__file__)), cs.PKG, "_build", "traces",
                                      "profile_step"))
    for cat in ("GEMM", "convolution"):
        rows = sorted(((v["seconds"] * 1e3 / 3, v["count"] / 3, n) for n, v in parsed["device_time"].items()
                       if tool.category(n, v["category"]) == cat), reverse=True)
        for ms, count, name in rows:
            cs.log(f"{cat}: {ms:.3f} ms {count:.0f}x {name[:160]}")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = cs.phase_tools(torch, kernels, 0, card, ckpt)
    cs.log(f"phase 17 {time.perf_counter() - t1:.1f} s; all {time.perf_counter() - t0:.1f} s")
finally:
    shutil.rmtree(ckpt, ignore_errors=True)
