"""One side of a parent / change comparison of the eager DESTR train step on
one card: run from the root of a tree (a checkout of either commit), it
builds that tree's production recipe through its chip_smoke.py (hidden 256,
B=16, bf16, dropout 0.3, device-cached batches, phase 6a's setup), takes 3
eager steps, times 10 more (CUDA events between steps, as phase 6a does), and
then times the AdamW update alone on the last step's gradients: with the
host's launches (CUDA events, median of 10) and on the device only (replays
of a CUDA graph of it, chip_smoke.device_ms). The eager step is bound by the
host's launches, and the host's speed differs from process to process, so
a host probe is timed before and after the steps: 5000 launches of an add on
one element, their host time a launch (median of 6 rounds); ``eager_per_probe``
is the step's median over it. Prints one line ``AB {json}``.

    artifacts/port_ab_r1/run.sh PARENT CHANGE OUT artifacts/port_ab_r1/eager_one.py 5
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

cs.phase_device(torch)
cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, auction.LIBRARY])
setup = cs.destr_capture_setup(torch, 0, [])
state, cache = setup["state"], setup["cache"]
_, idx = cache.epoch_index_matrix()
rows = torch.from_numpy(idx).cuda()
gen = torch.Generator(device="cuda")


def step():
    gen.manual_seed(setup["aug_seed"](state.step))
    setup["train_step"](state, setup["transform"](cache.gather(rows[state.step % len(rows)]), gen))


def probe():
    """Host microseconds a launch of a one-element add (median of 3 rounds)."""
    t = torch.zeros(1, device="cuda")
    rounds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5000):
            t.add_(1)
        rounds.append((time.perf_counter() - t0) / 5000 * 1e6)
    torch.cuda.synchronize()
    return rounds


for _ in range(3):
    step()
probes = probe()
events = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
torch.cuda.synchronize()
events[0].record()
for event in events[1:]:
    step()
    event.record()
torch.cuda.synchronize()
eager = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
probe_us = statistics.median(probes + probe())
update_ms = cs.time_cuda(torch, state.optimizer.step, reps=10, warmup=2)
update_device_ms = cs.device_ms(torch, state.optimizer.step)
print("AB " + json.dumps({"tree": os.path.basename(os.getcwd()), "eager_ms": statistics.median(eager),
                          "eager_ms_all": eager, "probe_us": probe_us,
                          "eager_per_probe": statistics.median(eager) / probe_us, "update_ms": update_ms,
                          "update_device_ms": update_device_ms}), flush=True)
