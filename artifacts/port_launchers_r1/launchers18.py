"""Phase 18 of chip_smoke.py alone (the port's launchers as subprocesses),
after the device check and the kernel build, on one GPU:

    python3 artifacts/port_launchers_r1/launchers18.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import chip_smoke  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

t0 = time.perf_counter()
card = chip_smoke.phase_device(torch)
chip_smoke.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY, auction.LIBRARY])
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
out = chip_smoke.phase_launchers(card)
print(json.dumps(out), flush=True)
