"""One side of a parent / change comparison of DESTR's float32 backward on
one card: run from the root of a tree (a checkout of either commit), it
builds that tree's flash kernels and, through its chip_smoke.py:

1. kernel cells, float32, B=16, masked as on the path, at dropout 0 and
   0.3: the backward that the tree's plan runs at each training call site of
   hidden 256, 512 and 1024 (#2, or #3 and #4), its gradients against the
   plain version's (errors relative to each tensor's largest value), its
   device time a launch (CUDA-graph replay of the wrapper's call, with its
   delta and, for #2, the dQ zeroing and cast) and eager time, the plain
   version's eager time, SDPA's float32 forward + backward (eager; or the
   reason SDPA gave for refusing) and the float32 bound
   (``chip_smoke.bound_ms``);
2. the train-640-f32 cell: the production recipe with ``--compute_dtype
   float32`` at hidden 256 through ``train.train.main`` (4 steps, launches
   a step) and phase 6a's captured-against-eager check with 3 eager samples
   a step (step times eager and captured in turns, idle shares, launches a
   replayed step and every kernel's device ms a step from the traces, peak
   memory).

Prints the card (nvidia-smi name, power limit) and one line ``AB {json}``.

    python3 artifacts/port_f32_bwd_r1/f32_one.py [--cells-only | --train-only]
    bash artifacts/port_ab_r1/run.sh PARENT CHANGE OUT artifacts/port_f32_bwd_r1/f32_one.py
"""
import json
import os
import re
import statistics
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import auction  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

SEED = 0
F32_EXTRA = ["--compute_dtype", "float32"]
KINDS = {"fused": (("bwd", fa.flash_attention_bwd, fa.flash_attention_packed_backward_reference),),
         "two_pass": (("dq", fa.flash_attention_dq, fa.flash_attention_dq_reference),
                      ("dkv", fa.flash_attention_dkv, fa.flash_attention_dkv_reference))}


def cell(gen, site, optin):
    """One call site's float32 backward at dropout 0 and 0.3 (see above)."""
    name, sq, sk, h, d, dv, masked = site
    q, k, v, dout = (torch.randn(cs.TRAIN_B, s, h * w, generator=gen, device="cuda")
                     for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
    mask = None
    if masked:
        lengths = torch.randint(sk * 3 // 4, sk + 1, (cs.TRAIN_B,), generator=gen, device="cuda")
        mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
    plan = fa.backward_plan(d, dv, torch.float32, optin)
    row = {"site": name, "d": d, "dv": dv, "plan": plan, "rel_err": {}}
    for kind, _, _ in KINDS[plan]:
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = cs.bound_ms(cs.TRAIN_B, sq, sk, h, d, dv, 4, masked,
                                                                       "float32", kind)
    for rate in (0.0, cs.RATE):
        seed = 1234 if rate else None
        out, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, rate, seed)
        args = (q, k, v, h, mask, out, lse, dout, None, rate, seed)
        for kind, kernel, reference in KINDS[plan]:
            got, ref = kernel(*args), reference(*args)
            got, ref = (got,) if kind == "dq" else got, (ref,) if kind == "dq" else ref
            names = {"bwd": ("dq", "dk", "dv"), "dq": ("dq",), "dkv": ("dk", "dv")}[kind]
            row["rel_err"].update({f"{n} rate {rate}": cs._rel(g, r) for n, g, r in zip(names, got, ref)})
            del got, ref
            row[f"{kind}_device_ms_{rate}"] = cs.device_ms(torch, lambda: kernel(*args))
            if rate:
                row[f"{kind}_ms"] = cs.time_cuda(torch, lambda: kernel(*args))
                row[f"{kind}_plain_ms"] = cs.time_cuda(torch, lambda: reference(*args))
        if rate:
            bias = None
            if mask is not None:
                bias = torch.zeros(cs.TRAIN_B, 1, 1, sk, device="cuda")
                bias.masked_fill_(~mask[:, None, None, :], -1e9)
            qg, kg, vg = (t.view(cs.TRAIN_B, -1, h, w).transpose(1, 2).detach().requires_grad_(True)
                          for t, w in ((q, d), (k, d), (v, dv)))
            doh = dout.view(cs.TRAIN_B, sq, h, dv).transpose(1, 2)
            row["sdpa_fwd_bwd_ms"], row["sdpa_note"] = cs.sdpa_ms(torch, cs.time_cuda, lambda: F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=bias, dropout_p=rate).backward(doh))
            del qg, kg, vg
        del out, lse, args
    row["ok"] = max(row["rel_err"].values()) <= cs.BWD_TOL["float32"]
    cs.log(f"f32 {name:19s} d={d} dv={dv} {plan} " + json.dumps(cs._rounded(row)))
    del q, k, v, dout
    torch.cuda.empty_cache()
    return row


def trace_kernel_ms(parsed):
    """Device ms a step of #1, #2, #3, #4, #9 in a parsed trace of 3 steps."""
    out = [0.0] * 5
    for name, entry in parsed["device_time"].items():
        for i, pattern in enumerate(cs.KERNEL_NAME_PATTERNS[:5]):
            if re.search(pattern, name):
                out[i] += entry["seconds"] * 1e3 / len(parsed["steps"])
                break
    return out


def main():
    card = cs.phase_device(torch)
    cs.phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY, auction.LIBRARY])
    cs.warm_clocks(torch)
    result = {"tree": os.path.basename(os.getcwd()), "card": card}
    if "--train-only" not in sys.argv:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
        optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
        rows = [cell(gen, site, optin) for site in cs.PATH_SITES + cs.WIDE_SITES + cs.H1024_SITES]
        result["cells"] = rows
        for label, sites in (("hidden_256", cs.PATH_SITES), ("hidden_512", cs.WIDE_SITES),
                             ("hidden_1024", cs.H1024_SITES)):
            names = {s[0] for s in sites}
            step = {}
            for key in ("bwd_device_ms_0.0", f"bwd_device_ms_{cs.RATE}", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                        "dq_device_ms_0.0", f"dq_device_ms_{cs.RATE}", "dq_ms", "dq_bound_ms",
                        "dkv_device_ms_0.0", f"dkv_device_ms_{cs.RATE}", "dkv_ms", "dkv_bound_ms", "sdpa_fwd_bwd_ms"):
                values = [r[key] for r in rows if r["site"] in names and key in r]
                step[key] = None if not values or None in values else cs.BLOCKS * sum(values)
            result[f"{label}_step"] = step
            cs.log(f"f32 {label}: a step's launches (6 blocks of each site), ms " + json.dumps(cs._rounded(step)))
        if not all(r["ok"] for r in rows):
            raise AssertionError("float32 backward cells out of tolerance: "
                                 + json.dumps([r for r in rows if not r["ok"]][:2]))
    if "--cells-only" not in sys.argv:
        kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
                   auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
                   fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]
        state, counts, step_ms = cs.phase_train(torch, kernels, SEED, F32_EXTRA, (18, 18, 0, 0, 1, 0, 0, 0, 0),
                                                "hidden 256 float32")
        del state
        torch.cuda.empty_cache()
        windows = []
        traced = cs.traced

        def keep_window(*args, **kwargs):
            parsed = traced(*args, **kwargs)
            windows.append(parsed)
            return parsed

        cs.traced = keep_window
        cap = cs.phase_captured_train(torch, kernels, cs.destr_capture_setup(torch, SEED, F32_EXTRA),
                                      (18, 18, 0, 0, 1, 0), "hidden 256 float32", eager_runs=3)
        cs.traced = traced
        cap.pop("spread", None)
        result["train"] = {"launches": counts, "eager_median_ms": step_ms, **cap,
                           "kernel_ms_a_step": {kind: trace_kernel_ms(w) for kind, w in zip(("eager", "captured"),
                                                                                             windows)}}
        cs.log("f32 train-640-f32: device ms a step of #1/#2/#3/#4/#9 from the traces "
               + json.dumps(cs._rounded(result["train"]["kernel_ms_a_step"])))
    print("AB " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
