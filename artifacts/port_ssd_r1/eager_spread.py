"""Where the port's SSD300 training step differs from itself on the card.

From one cloned state, at each of steps 1-3 of the recipe that
``chip_smoke.py`` trains (``ssd_capture_setup``: B=32, 300 px, bf16, paper
mining, the device cache), six eager steps and three CUDA-graph replays
through the EpochRunner; for every parameter, Adam's first moment, the
parameter and every buffer, the largest difference between eager samples,
between the replays and the eager mean, and between replays, relative to
the tensor's largest value. Once with cuDNN's default engines, once with
``torch.backends.cudnn.deterministic``. Run from the repository's root on a
machine with one CUDA card:

    python3 artifacts/port_ssd_r1/eager_spread.py
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner  # noqa: E402

N_EAGER, N_REPLAY, STEPS = 6, 3, 3


def run(name: str, deterministic: bool) -> None:
    print(f"== cuDNN {name}", flush=True)
    torch.backends.cudnn.deterministic = deterministic
    setup = cs.ssd_capture_setup(torch, 0)
    state, cache, transform, train_step = setup["state"], setup["cache"], setup["transform"], setup["train_step"]
    _, idx = cache.epoch_index_matrix()
    rows = torch.from_numpy(idx).cuda()
    gen = torch.Generator(device="cuda")
    opt = state.optimizer

    def eager_step():
        gen.manual_seed(setup["aug_seed"](state.step))
        train_step(state, transform(cache.gather(rows[state.step % len(rows)]), gen))

    def sample():
        torch.cuda.synchronize()
        return {"m": {n: v.detach().clone() for n, v in opt.m.items()},
                "param": {n: p.detach().float().clone() for n, p in state.model.named_parameters()},
                "buffer": {n: b.detach().float().clone() for n, b in state.model.named_buffers()}}

    def same(a, b):
        return all(torch.equal(a["m"][n], b["m"][n]) for n in a["m"])

    runner = EpochRunner(state, setup["step_core"], transform, cache.data, setup["aug_seed"], len(cache))
    runner.run(idx[:1], 0)  # step 0: warm-up and capture
    for step in range(1, STEPS + 1):
        snapshot = [t.detach().clone() for t in cs._state_tensors(state)]
        eager, replays = [], []
        for _ in range(N_EAGER):
            cs._restore(torch, state, snapshot, step)
            eager_step()
            eager.append(sample())
        for _ in range(N_REPLAY):
            cs._restore(torch, state, snapshot, step)
            runner.run(idx[[step % len(idx)]], step)
            replays.append(sample())
        distinct = [e for i, e in enumerate(eager) if not any(same(e, f) for f in eager[:i])]
        print(f"step {step}: {len(distinct)} distinct of {N_EAGER} eager samples (Adam's first moment, bitwise); "
              f"replays equal to an eager sample: {[any(same(r, e) for e in eager) for r in replays]}")
        for kind in ("m", "param", "buffer"):
            differ = []
            for n in eager[0][kind]:
                e = torch.stack([s[kind][n].double() for s in eager])
                r = torch.stack([s[kind][n].double() for s in replays])
                scale = float(e.abs().max()) or 1.0
                d = (float((e - e[0]).abs().max()) / scale, float((r - e.mean(0)).abs().max()) / scale,
                     float((r - r[0]).abs().max()) / scale)
                if any(d):
                    differ.append((n, *d))
            differ.sort(key=lambda row: -max(row[1:3]))
            print(f"  {kind}: {len(differ)} of {len(eager[0][kind])} tensors differ; largest (eager-eager, "
                  f"replay-eager mean, replay-replay, relative to the tensor's largest value):")
            for n, *d in differ[:6]:
                print(f"    {n:24s} {d[0]:.3e} {d[1]:.3e} {d[2]:.3e}")
        cs._restore(torch, state, snapshot, step)
        runner.run(idx[[step % len(idx)]], step)
    torch.backends.cudnn.deterministic = False


def main() -> int:
    if not torch.cuda.is_available():
        print("eager_spread: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.phase_device(torch)
    for name, deterministic in (("default engines", False), ("deterministic engines", True)):
        run(name, deterministic)
        torch.cuda.empty_cache()
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
