"""Where the float32 fused backward's time goes, on the card: copies of
csrc/flash_attention_bwd.cu with one thing changed each (a part switched
off, the rounding split instead of the truncating one, the warp count forced)
are built under object_detection_destr_tpu_torch/_build/variants/ and timed
beside the kernel as it is, at the float32 training step's #2 sites (B=16,
dropout 0.3, masked as on the path; device ms a launch from CUDA-graph
replay, chip_smoke.device_ms). A copy with a part switched off computes
wrong gradients by design: only its time is read. The rounding-split and
forced-warp copies compute the same function: their errors against the
plain version are printed beside their times.

    python3 artifacts/port_f32_bwd_r1/variants.py   (from the repo's root, on the card)

Prints the card (nvidia-smi name, power limit) and one line ``VARIANTS {json}``.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import build  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

HEADERS = ("flash_common.cuh", "philox.cuh", "tensor_core.cuh")
SITES = cs.PATH_SITES + cs.WIDE_SITES[1:2]  # d 32, 64, 512 / 256 and hidden 512's d 128


def insert(src, anchor, before="", after=""):
    """``src`` with ``before`` and ``after`` put around its one ``anchor``."""
    assert src.count(anchor) == 1, anchor
    return src.replace(anchor, before + anchor + after)


def variant_source(src):
    """The kernel source with compile-time switches for the variants."""
    a = src.index("    // 3. dK += dS^T Q and dV += (P keep)^T dO")
    b = src.index("    // 4. dQ += dS K: jobs of")
    c = src.index("    __syncthreads();\n  }\n\n  for (int i = threadIdx.x; i < kF32Keys * d;")
    src = (src[:a] + "#ifndef NO_STEP3\n" + src[a:b] + "#endif\n#ifndef NO_STEP4\n" + src[b:c] + "#endif\n"
           + src[c:])
    src = insert(src, "          if (vec_dq) {  // d even", before="#ifdef NO_ATOMIC\n          if (x0 == 1234.5f) *at = x1;\n"
                 "          continue;\n#endif\n")
    f32 = slice(src.index("// ---- float32 on the tensor cores"), src.index("// ---- bfloat16 on the tensor cores"))
    body = src[f32].replace("tc::split_tf32_trunc(", "SPLIT(")
    src = src[:f32.start] + ("#ifdef ROUND_SPLIT\n#define SPLIT tc::split_tf32\n#else\n#define SPLIT tc::split_tf32_trunc\n"
                             "#endif\n") + body + src[f32.stop:]
    dispatch = "  return L.warps == 8 ? launch_f32<8, 32>(a, L.total) : launch_f32<4, 64>(a, L.total);"
    return insert(src, dispatch, before="#if defined(WARPS8)\n  return launch_f32<8, 32>(a, L.total + (L.warps == 8 ? 0 : "
                  "sizeof(float) * kF32Exchange));\n#elif defined(WARPS4)\n  return launch_f32<4, 64>(a, L.total);\n#else\n",
                  after="\n#endif")


VARIANTS = {"as_is": [], "no_atomic": ["-DNO_ATOMIC"], "no_step3": ["-DNO_STEP3"], "no_step4": ["-DNO_STEP4"],
            "no_step3_4": ["-DNO_STEP3", "-DNO_STEP4"], "round_split": ["-DROUND_SPLIT"], "warps4": ["-DWARPS4"],
            "warps8": ["-DWARPS8"]}
SAME_FUNCTION = ("as_is", "round_split", "warps4", "warps8")


def main():
    card = cs.phase_device(torch)
    out = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(build.CSRC, "flash_attention_bwd.cu")) as f:
        source = variant_source(f.read())
    with open(os.path.join(out, "flash_attention_bwd.cu"), "w") as f:
        f.write(source)
    for h in HEADERS:
        with open(os.path.join(build.CSRC, h)) as f, open(os.path.join(out, h), "w") as g:
            g.write(f.read())
    wrappers = {}
    for name, flags in VARIANTS.items():
        lib = build.CudaLibrary("odtt_bwd_variant_" + name, os.path.join(out, "flash_attention_bwd.cu"),
                                headers=[os.path.join(out, h) for h in HEADERS],
                                functions=fa.BWD_LIBRARY.functions, abi=fa.BWD_LIBRARY.abi, flags=flags)
        wrappers[name] = type("Variant", (fa.FlashAttentionBackward,), {"library": lib})()
    cs.phase_build([fa.FWD_LIBRARY] + [w.library for w in wrappers.values()])
    cs.warm_clocks(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, sq, sk, h, d, dv, masked in SITES:
        q, k, v, dout = (torch.randn(cs.TRAIN_B, s, h * w, generator=gen, device="cuda")
                         for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
        lengths = torch.randint(sk * 3 // 4, sk + 1, (cs.TRAIN_B,), generator=gen, device="cuda")
        mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None] if masked else None
        out_, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, cs.RATE, 7)
        args = (q, k, v, h, mask, out_, lse, dout, None, cs.RATE, 7)
        ref = fa.flash_attention_packed_backward_reference(*args)
        row = {"site": name, "d": d, "dv": dv, "device_ms": {}, "rel_err": {}}
        for vname, wrapper in wrappers.items():
            got = wrapper(*args)
            if vname in SAME_FUNCTION:
                row["rel_err"][vname] = max(cs._rel(g, r) for g, r in zip(got, ref))
            row["device_ms"][vname] = cs.device_ms(torch, lambda: wrapper(*args))
        cs.log(f"variants {name:19s} d={d} dv={dv} ({card}) " + json.dumps(cs._rounded(row)))
        rows.append(row)
    bad = {r["site"]: r["rel_err"] for r in rows if max(r["rel_err"].values()) > cs.BWD_TOL["float32"]}
    print("VARIANTS " + json.dumps({"card": card, "rows": rows}), flush=True)
    if bad:
        raise AssertionError(f"variants computing the same function out of tolerance: {bad}")


if __name__ == "__main__":
    main()
