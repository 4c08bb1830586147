"""Where the float32 two-pass kernels' time goes, on the card: copies of
csrc/flash_attention_bwd_two_pass.cu with one part of the float32 kernels
switched off each are built under object_detection_destr_tpu_torch/_build/
variants_two_pass/ and timed beside the kernels as they are (B=16, float32,
dropout 0.3, masked as on the path; device ms a launch of #3 and of #4 from
CUDA-graph replay, chip_smoke.device_ms), at hidden 512's cross-attention
(d 1024, dv 512: flash_two_pass_f32_kernel) and hidden 1024's (d 2048, dv
1024: flash_two_pass_f32_wide_kernel). A copy with a part switched off
computes wrong gradients by design: only its time is read; the copy as it
is must give the library's bits.

    python3 artifacts/port_f32_two_pass_r1/variants.py   (from the repo's root, on the card)

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
SOURCE = "flash_attention_bwd_two_pass.cu"
SITES = [cs.WIDE_CROSS, cs.H1024_CROSS]


def guard(src, anchor, macro, replacement=""):
    """``src`` with its one ``anchor`` (after the float32 section's start)
    compiled only without ``macro``, ``replacement`` in its place with it."""
    start = src.index("// ---- float32 on the tensor cores, in 3xTF32")
    assert src.count(anchor, start) == 1, anchor
    at = src.index(anchor, start)
    return (src[:at] + f"#ifdef {macro}\n{replacement}#else\n{anchor}#endif\n" + src[at + len(anchor):])


def variant_source(src):
    """The source with compile-time switches for the variants."""
    # flash_two_pass_f32_kernel: 1. S and dP, 2. the pairs, 3. the jobs, the stage loads
    src = guard(src, "    tc::mma_abt_3xtf32(sp, own1_s + c1, L.s1, st1 + c1, L.s1, n1, g, t);\n"
                     "    tc::mma_abt_3xtf32(dpp, own2_s + c2, L.s2, st2 + c2, L.s2, n2, g, t);\n",
                "NO_S1", "    float sp[4] = {st1[g], 0.f, 0.f, 0.f}, dpp[4] = {st2[g], 0.f, 0.f, 0.f};\n")
    src = src.replace("    float sp[4], dpp[4];\n#ifdef NO_S1", "#ifdef NO_S1")
    src = src.replace("#else\n    tc::mma_abt_3xtf32(sp,", "#else\n    float sp[4], dpp[4];\n    tc::mma_abt_3xtf32(sp,")
    src = guard(src, "        ds = pair_grad(a, state, dot, dp, DKV ? lse_c : own_lse, DKV ? delta_c : own_delta, seed, bh, "
                     "row, key, pd);\n", "NO_S2", "        ds = dot * a.scale, pd = dp;\n")
    src = guard(src, "      if (!DKV || job < nd8)  // dK or dQ columns\n", "NO_S3", "      if (false)\n")
    src = guard(src, "      load(it + 1);\n", "NO_LOADS", "      tc::cp_async_commit();\n")
    # flash_two_pass_f32_wide_kernel: 1. S / dP steps, 3. the gradient steps, the loads
    src = guard(src, "      tc::mma_abt_3xtf32(c, slot, kF32WideStride, str_s + 8 * warp * kF32WideStride, kF32WideStride, "
                     "cw, g, t);\n", "NO_S1", "      c[0] = slot[g]; c[1] = c[2] = c[3] = 0.f;\n")
    src = guard(src, "      if (gc * kWideCols + 16 * warp < sw) {\n", "NO_S3", "      if (false) {\n")
    src = guard(src, "    if (s + 1 < total) load(s + 1);\n", "NO_LOADS", "")
    return src


VARIANTS = {"as_is": [], "no_step1": ["-DNO_S1"], "no_step2": ["-DNO_S2"], "no_step3": ["-DNO_S3"],
            "no_loads": ["-DNO_LOADS"], "no_step1_3": ["-DNO_S1", "-DNO_S3"]}


def main():
    card = cs.phase_device(torch)
    out = os.path.join(build.BUILD_DIR, "variants_two_pass")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(build.CSRC, SOURCE)) as f:
        source = variant_source(f.read())
    with open(os.path.join(out, SOURCE), "w") as f:
        f.write(source)
    for h in HEADERS:
        with open(os.path.join(build.CSRC, h)) as f, open(os.path.join(out, h), "w") as g:
            g.write(f.read())
    wrappers = {}
    for name, flags in VARIANTS.items():
        lib = build.CudaLibrary("odtt_two_pass_variant_" + name, os.path.join(out, SOURCE),
                                headers=[os.path.join(out, h) for h in HEADERS],
                                functions=fa.TWO_PASS_LIBRARY.functions, abi=fa.TWO_PASS_LIBRARY.abi, flags=flags)
        wrappers[name] = {kind: type("Variant", (fa.FlashAttentionTwoPass,), {"library": lib})(dq=kind == "dq")
                          for kind in ("dq", "dkv")}
    cs.phase_build([fa.FWD_LIBRARY, fa.TWO_PASS_LIBRARY] + [w["dq"].library for w in wrappers.values()])
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
        lib_grads = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
        row = {"site": name, "d": d, "dv": dv, "device_ms": {}}
        for vname, pair in wrappers.items():
            if vname == "as_is":
                got = (pair["dq"](*args), *pair["dkv"](*args))
                row["as_is_equal_to_library"] = all(torch.equal(g, r) for g, r in zip(got, lib_grads))
            for kind, wrapper in pair.items():
                row["device_ms"][f"{kind} {vname}"] = cs.device_ms(torch, lambda: wrapper(*args))
        cs.log(f"variants {name:19s} d={d} dv={dv} ({card}) " + json.dumps(cs._rounded(row)))
        rows.append(row)
    print("VARIANTS " + json.dumps({"card": card, "rows": rows}), flush=True)
    if not all(r["as_is_equal_to_library"] for r in rows):
        raise AssertionError("the unmodified copy does not give the library's bits")


if __name__ == "__main__":
    main()
