"""chip_smoke.py's phase 22 alone (the greedy-match kernel against its plain
version, both metrics on the card against the plain version, the captured
eval step against the eager one for DESTR at config 2's shapes and SSD at
config 1's), then, with ``--parent DIR``, the trainers' validation sweeps of
the parent checkout and of this one on one card, in turns parent, change,
change, parent (``sweep_ab.py``, one process a turn).

    python3 artifacts/port_val_device_r1/val_22.py [--parent scratch_chip/parent]   # one H100
"""
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import greedy_match as gm  # noqa: E402

kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
           auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
           fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]
t0 = time.perf_counter()
card = cs.phase_device(torch)
cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, auction.LIBRARY, gm.LIBRARY])
out = cs.phase_val_device(torch, kernels, 0, card)
cs.log(f"phase 22 {out['seconds']:.1f} s; with the build {time.perf_counter() - t0:.1f} s ({card})")
cs.log("PHASE22 " + json.dumps(cs._rounded({k: v for k, v in out.items()}), default=str))

if "--parent" in sys.argv:
    parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, cs.PKG, "_build")) as work:
        coco = os.path.join(work, "coco")
        cs.write_coco_tree(coco, 0, n_train=16, n_valid=96)
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sweep_ab.py")
        for tree in (parent, REPO, REPO, parent):
            done = subprocess.run([sys.executable, script, tree, coco], capture_output=True, text=True)
            lines = [line for line in done.stdout.splitlines() if line.startswith("SWEEP ")]
            if done.returncode != 0 or not lines:
                print(done.stdout[-3000:], done.stderr[-6000:], file=sys.stderr)
                raise SystemExit(f"sweep_ab on {tree} exited {done.returncode}")
            cs.log(lines[-1])
cs.log(f"val_22 done in {time.perf_counter() - t0:.1f} s ({card})")
