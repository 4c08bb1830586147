"""Design 2 of the float32 two-pass kernel, tried against the one the port
keeps, on the card. design2_f32_kernel.cuh holds its float32 section: the
own rows' A fragments in registers (float32, split where used) instead of
shared memory, so stages of 16 streamed rows fit; dK and dV in separate
blocks (column slices of at most 1024, as the wide kernels take them),
because the accumulators of both beside the A fragments pass a thread's
registers. This script splices it into a copy of
csrc/flash_attention_bwd_two_pass.cu under
object_detection_destr_tpu_torch/_build/design2/, builds that copy beside
the library, holds design 2 against the plain versions (float32, every
class: small and odd widths, the path's cross sites, d 1040 / 1536 / 2048,
Sk 7056) and times both designs, device ms a launch of #3 and #4 (CUDA-graph
replay, chip_smoke.device_ms; B=16, float32, dropout 0.3, masked as on the
path), twice each, at the cross-attention of hidden 256, 512 and 1024 and
the encoder and decoder self-attention of hidden 256. ptxas's registers and
spills of both builds are printed.

    python3 artifacts/port_f32_two_pass_r1/design2.py   (from the repo's root, on the card)

Prints the card (nvidia-smi name, power limit) and one line ``DESIGN2 {json}``.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import build  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
HEADERS = ("flash_common.cuh", "philox.cuh", "tensor_core.cuh")
SOURCE = "flash_attention_bwd_two_pass.cu"
SMALL = [("s32", 64, 48, 2, 32, 32, True), ("s17", 40, 33, 3, 17, 17, True), ("s100_60", 70, 90, 2, 100, 60, True),
         ("s1400_128", 50, 70, 1, 1400, 128, True), ("s8_1500", 50, 37, 1, 8, 1500, True)]


def design2_source(src):
    """The library's source with design 2's float32 section and its plan
    (16 streamed rows, the slices of the wide kernels) and launches."""
    with open(os.path.join(HERE, "design2_f32_kernel.cuh")) as f:
        section = f.read()
    a = src.index("// ---- float32 on the tensor cores, in 3xTF32")
    b = src.index("// ---- float32 on the tensor cores, the wide class")
    src = src[:a] + section + "\n" + src[b:]
    old = "      return {0, cls, kF32TR, 1, (int)F32Layout(d, dv).total};"
    assert src.count(old) == 1
    src = src.replace(old, "      return {0, cls, kF32TR, slices, (int)F32Layout(d, dv).total};")
    for c in (2, 4, 8, 12, 16, 24):
        old = f"    case {c}: return launch(flash_two_pass_f32_kernel<DKV, {c}>, a, p, DKV, stream);"
        assert src.count(old) == 1, old
        src = src.replace(old, old[:-2] + ", n1, p.slices);")
    return src


def main():
    card = cs.phase_device(torch)
    out = os.path.join(build.BUILD_DIR, "design2")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(build.CSRC, SOURCE)) as f:
        source = design2_source(f.read())
    with open(os.path.join(out, SOURCE), "w") as f:
        f.write(source)
    for h in HEADERS:
        with open(os.path.join(build.CSRC, h)) as f, open(os.path.join(out, h), "w") as g:
            g.write(f.read())
    lib = build.CudaLibrary("odtt_two_pass_design2", os.path.join(out, SOURCE),
                            headers=[os.path.join(out, h) for h in HEADERS],
                            functions=fa.TWO_PASS_LIBRARY.functions, abi=fa.TWO_PASS_LIBRARY.abi)
    design2 = {kind: type("Design2", (fa.FlashAttentionTwoPass,), {"library": lib})(dq=kind == "dq")
               for kind in ("dq", "dkv")}
    cs.phase_build([fa.FWD_LIBRARY, fa.TWO_PASS_LIBRARY, lib])
    cs.warm_clocks(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for b, sites in ((3, SMALL), (cs.TRAIN_B, [cs.PATH_SITES[2], cs.WIDE_CROSS] + cs.BEYOND_SITES + [cs.H1024_CROSS]),
                     (1, [cs.WIDE_LONG])):
        for name, sq, sk, h, d, dv, masked in sites:
            q, k, v, dout = (torch.randn(b, s, h * w, generator=gen, device="cuda")
                             for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
            lengths = torch.randint(sk * 3 // 4, sk + 1, (b,), generator=gen, device="cuda")
            lengths[0] = 0  # a fully masked batch entry
            mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
            for rate in (0.0, cs.RATE) if b > 1 else (0.0,):
                seed = 5 if rate else None
                out_, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, rate, seed)
                args = (q, k, v, h, mask, out_, lse, dout, None, rate, seed)
                ref = (fa.flash_attention_dq_reference(*args), *fa.flash_attention_dkv_reference(*args))
                got = (design2["dq"](*args), *design2["dkv"](*args))
                checks.append({"site": name, "b": b, "rate": rate,
                               "rel_err": max(cs._rel(g, r) for g, r in zip(got, ref))})
            del q, k, v, dout
            torch.cuda.empty_cache()
    cs.log(f"design 2 against the plain versions ({card}): " + json.dumps(cs._rounded(checks)))
    times = {}
    for name, sq, sk, h, d, dv, masked in [cs.PATH_SITES[2], cs.WIDE_CROSS, cs.H1024_CROSS, cs.SITES[0], cs.SITES[1]]:
        q, k, v, dout = (torch.randn(cs.TRAIN_B, s, h * w, generator=gen, device="cuda")
                         for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
        lengths = torch.randint(sk * 3 // 4, sk + 1, (cs.TRAIN_B,), generator=gen, device="cuda")
        mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None] if masked else None
        out_, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, cs.RATE, 7)
        args = (q, k, v, h, mask, out_, lse, dout, None, cs.RATE, 7)
        row = {}
        for label, dq_w, dkv_w in (("kept", fa.flash_attention_dq, fa.flash_attention_dkv),
                                   ("design2", design2["dq"], design2["dkv"])):
            for r in range(2):
                row[f"{label} dq {r}"] = cs.device_ms(torch, lambda: dq_w(*args))
                row[f"{label} dkv {r}"] = cs.device_ms(torch, lambda: dkv_w(*args))
        times[name] = row
        cs.log(f"design 2 against the kept design {name} d={d} dv={dv} ({card}) " + json.dumps(cs._rounded(row)))
    print("DESIGN2 " + json.dumps({"card": card, "checks": checks, "device_ms": times}), flush=True)
    worst = max(c["rel_err"] for c in checks)
    if worst > cs.BWD_TOL["float32"]:
        raise AssertionError(f"design 2 out of tolerance: {worst}")


if __name__ == "__main__":
    main()
