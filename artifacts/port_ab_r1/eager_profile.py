"""Where the host's time goes in an eager DESTR train step, for one tree:
run from the root of a tree (a checkout of either commit), it builds phase
6a's recipe as eager_one.py does, takes 3 eager steps, and then profiles 3
more twice: with cProfile (the Python functions by their own time) and with
torch.profiler (the operators and CUDA runtime calls by count and host
time). Writes both tables to OUT and prints one line ``PROFILE {json}``
with the step's host time (until train_step returns) and its time with a
synchronize after it, median of 5.

    (cd TREE && python3 /abs/artifacts/port_ab_r1/eager_profile.py OUT)
"""
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
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


for _ in range(3):
    step()
host, synced = [], []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    synced.append((time.perf_counter() - t0) * 1e3)
out = io.StringIO()
prof = cProfile.Profile()
prof.enable()
for _ in range(3):
    step()
torch.cuda.synchronize()
prof.disable()
pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(40)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
    for _ in range(3):
        step()
    torch.cuda.synchronize()
events = tp.key_averages()
out.write(events.table(sort_by="self_cpu_time_total", row_limit=60))
calls = {e.key: e.count for e in events if e.key.startswith("cuda")}
n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
with open(sys.argv[1], "w") as f:
    f.write(out.getvalue())
print("PROFILE " + json.dumps({"tree": os.path.basename(os.getcwd()), "host_ms": statistics.median(host),
                               "synced_ms": statistics.median(synced), "aten_calls_3_steps": n_ops,
                               "cuda_runtime_calls_3_steps": calls}), flush=True)
