"""One side of a parent / change comparison of DESTR's float32 two-pass
backward (#3 / #4) on one card: run from the root of a tree (a checkout of
either commit), it builds that tree's flash kernels and, through its
chip_smoke.py:

1. kernel cells, float32, B=16, masked as on the path, at dropout 0 and
   0.3, at the merged cross-attention of hidden 512 (d 1024, dv 512) and of
   hidden 1024 (d 2048, dv 1024): #3 and #4 against their plain versions,
   device time a launch (CUDA-graph replay) and eager time, the plain
   versions' eager time, SDPA's float32 forward + backward and the float32
   bound (``cell`` of ``artifacts/port_f32_bwd_r1/f32_one.py``);
2. the train-640-wide-f32 cell: the production recipe with
   ``--hidden_dim 512 --compute_dtype float32`` through ``train.train.main``
   (4 steps, launches a step) and phase 6a's captured-against-eager check
   with 3 eager samples a step (step times eager and captured in turns, idle
   shares, launches a replayed step and every kernel's device ms a step from
   the traces, peak memory).

Prints the card (nvidia-smi name, power limit) and one line ``AB {json}``.

    python3 artifacts/port_f32_two_pass_r1/f32_one.py [--cells-only | --train-only]
    bash artifacts/port_ab_r1/run.sh PARENT CHANGE OUT artifacts/port_f32_two_pass_r1/f32_one.py
"""
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "f32_bwd_one", os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "port_f32_bwd_r1", "f32_one.py"))
f32_bwd_one = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(f32_bwd_one)

SEED = 0
EXTRA = cs.WIDE_ARGS + ["--compute_dtype", "float32"]
PER_STEP = (18, 12, 6, 6, 1, 0, 0, 0, 0)
STEP_KEYS = ("dq_device_ms_0.0", f"dq_device_ms_{cs.RATE}", "dq_ms", "dq_plain_ms", "dq_bound_ms",
             "dkv_device_ms_0.0", f"dkv_device_ms_{cs.RATE}", "dkv_ms", "dkv_plain_ms", "dkv_bound_ms",
             "sdpa_fwd_bwd_ms")


def main():
    card = cs.phase_device(torch)
    cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY, auction.LIBRARY])
    cs.warm_clocks(torch)
    result = {"tree": os.path.basename(os.getcwd()), "card": card}
    if "--train-only" not in sys.argv:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
        rows = [f32_bwd_one.cell(gen, site, optin) for site in (cs.WIDE_CROSS, cs.H1024_CROSS)]
        result["cells"] = rows
        for row in rows:  # a step's 6 launches at the site
            step = {key: None if row.get(key) is None else cs.BLOCKS * row[key] for key in STEP_KEYS}
            result[f"{row['site']}_step"] = step
            cs.log(f"f32 {row['site']}: a step's 6 launches, ms " + json.dumps(cs._rounded(step)))
        if not all(r["ok"] for r in rows):
            raise AssertionError("float32 two-pass cells out of tolerance: "
                                 + json.dumps([r for r in rows if not r["ok"]][:2]))
    if "--cells-only" not in sys.argv:
        kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
                   auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
                   fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]
        state, counts, step_ms = cs.phase_train(torch, kernels, SEED, EXTRA, PER_STEP, "hidden 512 float32")
        del state
        torch.cuda.empty_cache()
        windows = []
        traced = cs.traced

        def keep_window(*args, **kwargs):
            parsed = traced(*args, **kwargs)
            windows.append(parsed)
            return parsed

        cs.traced = keep_window
        cap = cs.phase_captured_train(torch, kernels, cs.destr_capture_setup(torch, SEED, EXTRA), PER_STEP[:6],
                                      "hidden 512 float32", eager_runs=3)
        cs.traced = traced
        cap.pop("spread", None)
        result["train"] = {"launches": counts, "eager_median_ms": step_ms, **cap,
                           "kernel_ms_a_step": {kind: f32_bwd_one.trace_kernel_ms(w)
                                                for kind, w in zip(("eager", "captured"), windows)}}
        cs.log("f32 train-640-wide-f32: device ms a step of #1/#2/#3/#4/#9 from the traces "
               + json.dumps(cs._rounded(result["train"]["kernel_ms_a_step"])))
    print("AB " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
