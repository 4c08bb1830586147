"""First chip check of the 3xTF32 two-pass kernels (run 1, log
r1_check1.txt): build, plans, every float32 width class against the plain
versions (small and odd widths, the path's cross sites, d 1040 / 1536 /
2048, Sk 7056, head-major bit-equality), bf16 and #2 unchanged, and the
device times of #3 / #4 at hidden 512's and 1024's cross-attention
(chip_smoke.phase_dropout_share).

    python3 artifacts/port_f32_two_pass_r1/check1.py   (from the repo's root, on the card)
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

t0 = time.perf_counter()
card = cs.phase_device(torch)
cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY])
cs.phase_plan(torch, fa)
cs.warm_clocks(torch)
gen = torch.Generator(device="cuda").manual_seed(0)
rows, bad = [], []
F32, BF16 = torch.float32, torch.bfloat16
small = [("s32", 64, 48, 2, 32, 32, True), ("s17", 40, 33, 3, 17, 17, True), ("s100_60", 70, 90, 2, 100, 60, True)]
for site in small:
    for rate in (0.0, 0.3):
        rows.append(cs.flash_cell(torch, gen, site, 3, F32, rate, True, "two_pass", False, rate == 0.0, timed=False))
for site in [cs.PATH_SITES[2], cs.WIDE_CROSS]:
    for rate in (0.0, 0.3):
        rows.append(cs.flash_cell(torch, gen, site, 16, F32, rate, True, "two_pass", False, rate == 0.0,
                                  timed=site is cs.WIDE_CROSS and rate > 0))
for site in cs.BEYOND_SITES + [cs.H1024_CROSS]:
    for rate in (0.0, 0.3):
        rows.append(cs.flash_cell(torch, gen, site, 16, F32, rate, True, "two_pass", False,
                                  site is cs.H1024_CROSS and rate == 0.0, timed=site is cs.H1024_CROSS and rate > 0))
for site in [cs.WIDE_LONG, cs.H1024_LONG]:
    rows.append(cs.flash_cell(torch, gen, site, 1, F32, 0.0, True, "two_pass", False, timed=False))
print("T f32 cells", time.perf_counter() - t0, flush=True)
for site in [cs.WIDE_CROSS, cs.H1024_CROSS]:
    rows.append(cs.flash_cell(torch, gen, site, 16, BF16, 0.3, True, "two_pass", False, timed=False))
rows.append(cs.flash_cell(torch, gen, cs.PATH_SITES[2], 16, F32, 0.3, True, "fused", False, timed=False))
rows.append(cs.flash_cell(torch, gen, cs.PATH_SITES[2], 16, BF16, 0.3, True, "fused", False, timed=False))
un = []
for site in cs.PATH_SITES + [cs.WIDE_CROSS]:
    for rate in (0.0, 0.3):
        un.append(cs.unpacked_cell(torch, gen, site, 16, F32, rate, timed=rate > 0 and site in cs.PATH_SITES))
un.append(cs.unpacked_cell(torch, gen, cs.H1024_CROSS, 16, F32, 0.3, timed=False))
shares = cs.phase_dropout_share(torch, 0, rows, F32, [cs.WIDE_CROSS, cs.H1024_CROSS])
bad = [r for r in rows + un if not r["ok"]]
print("T total", time.perf_counter() - t0, flush=True)
print("BAD", len(bad), [(r["site"], r["dtype"], r["rate"], r.get("bwd_rel_err")) for r in bad], flush=True)
sys.exit(1 if bad else 0)
