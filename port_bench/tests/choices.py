"""Why a training cell's worst leaf departs from the reference: the step's
discrete choices (the mini-detector's top-k tokens, each decoder block's
pair argmax, the auction's assignment), counted where the program and the
reference choose differently, and the reference run again with the
program's choices replayed in place of its own:

    python3 port_bench/tests/choices.py --workload train-coco-800 --seeds 11,12,13 \
        [--float32] [--out FILE]

For each seed the program makes the cell's checked steps through its own
call (the first eager with the capture, then replays), as a run does, and
records each choice; the captured ones are read after each replay. It
prints, for each checked step, how many choices differ (top-k tokens not
shared, queries paired otherwise, real targets assigned another row), and
the compared numbers of the reference as it is and of the reference that
takes the program's choices. ``--float32`` runs both sides in float32
instead of the configuration's bfloat16."""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench.harness import cli, compare, device, registry  # noqa: E402
from port_bench.harness.coco_tree import write_coco_tree  # noqa: E402
from port_bench.reference import steps as reference  # noqa: E402

SITES = ("topk", "pairs", "match")


def _cloned(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


class Recorder:
    """Each call's result at the three sites. Eager calls are kept as they
    run; calls made while a CUDA graph captures are kept as the tensors that
    its replays write, and :meth:`take` reads them after a replay."""

    def __init__(self):
        self.eager = {s: [] for s in SITES}
        self.graph = {s: [] for s in SITES}
        self.steps: list[dict] = []

    def wrap(self, site: str, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            kept = _cloned(out)
            if site == "match":  # the targets that are real, to count them
                kept = (*kept, args[2]["valid"].clone())
            capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
            into = self.graph if capturing else self.eager
            into[site].append(kept)
            return out

        return call

    def take(self) -> None:
        """The choices of the step that has just run."""
        source = self.eager if self.eager["match"] else self.graph
        self.steps.append({s: [_host(v) for v in source[s]] for s in SITES})
        self.eager = {s: [] for s in SITES}


def _host(v):
    return tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()


def _split(rec: Recorder, n_steps: int) -> list[dict]:
    """A reference run's records cut into its steps (one top-k, one match and
    the same number of pairings a step)."""
    flat = {s: [_host(v) for v in rec.eager[s]] for s in SITES}
    per = len(flat["pairs"]) // n_steps
    return [{"topk": flat["topk"][i:i + 1], "pairs": flat["pairs"][i * per:(i + 1) * per],
             "match": flat["match"][i:i + 1]} for i in range(n_steps)]


def differ(program: dict, ref: dict) -> dict:
    """How many choices of one step differ: top-k tokens of one side that
    the other did not select, queries whose (left, right) pair differs over
    all blocks, real targets whose row differs in each problem."""
    topk = sum(len(np.setdiff1d(a, b)) for pa, pb in zip(program["topk"], ref["topk"])
               for a, b in zip(pa.numpy(), pb.numpy()))
    pairs = sum(int((pa != pb).any(-1).sum()) for pa, pb in zip(program["pairs"], ref["pairs"]))
    (pm, pd, valid), (rm, rd, _) = program["match"][0], ref["match"][0]
    return {"topk": topk, "topk_of": sum(int(t.numel()) for t in program["topk"]),
            "pairs": pairs, "pairs_of": sum(int(t[..., 0].numel()) for t in program["pairs"]),
            "match_model": int(((pm != rm) & valid).sum()), "match_det": int(((pd != rd) & valid).sum()),
            "targets": int(valid.sum())}


def _program_sites(rec: Recorder):
    import object_detection_destr_tpu_torch.models.destr.mini_detector as md
    import object_detection_destr_tpu_torch.models.destr.pair_attention as pa
    import object_detection_destr_tpu_torch.train.steps as st

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(md, "masked_topk_with_recycle",
                                          rec.wrap("topk", md.masked_topk_with_recycle)))
    stack.enter_context(mock.patch.object(pa, "get_pairs", rec.wrap("pairs", pa.get_pairs)))
    stack.enter_context(mock.patch.object(st, "_match_pair", rec.wrap("match", st._match_pair)))
    return stack


def _reference_sites(rec: Recorder | None = None, replay: list[dict] | None = None):
    """The reference's three sites recorded (``rec``) or answered from the
    program's choices (``replay``, in call order)."""
    import port_bench.reference.mini_detector as md
    import port_bench.reference.pair_attention as pa

    stack = contextlib.ExitStack()
    if rec is not None:
        stack.enter_context(mock.patch.object(md, "masked_topk_with_recycle",
                                              rec.wrap("topk", md.masked_topk_with_recycle)))
        stack.enter_context(mock.patch.object(pa, "get_pairs", rec.wrap("pairs", pa.get_pairs)))
        stack.enter_context(mock.patch.object(reference, "match_pair", rec.wrap("match", reference.match_pair)))
        return stack
    queues = {s: iter([v for step in replay for v in step[s]]) for s in SITES}
    dev = device.cuda_or_cpu()
    stack.enter_context(mock.patch.object(md, "masked_topk_with_recycle",
                                          lambda *a, **k: next(queues["topk"]).to(dev)))
    stack.enter_context(mock.patch.object(pa, "get_pairs", lambda *a, **k: next(queues["pairs"]).to(dev)))
    stack.enter_context(mock.patch.object(reference, "match_pair",
                                          lambda *a, **k: tuple(t.to(dev) for t in next(queues["match"])[:2])))

    def used_up():
        left = [s for s, q in queues.items() if next(q, None) is not None]
        if left:
            raise RuntimeError(f"the reference made fewer choices than the program at {', '.join(left)}")

    stack.callback(used_up)
    return stack


def program_steps(ctx, generator, rec: Recorder) -> dict:
    """The program's first ``check_steps`` steps, one call each, as a run
    makes them, with each step's choices recorded."""
    p, dev = ctx.cell.params, device.cuda_or_cpu()
    root = f"{ctx.work_dir}/coco"
    write_coco_tree(root, ctx.seed, p["images"], sizes=[tuple(hw) for hw in p["sizes"]])
    with _program_sites(rec):
        runner, cache, state = generator._program(ctx, root, dev)
        _, idx = cache.epoch_index_matrix()
        start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
        losses = {k: [] for k in ("loss", "loss_model", "loss_det")}
        for step in range(p["check_steps"]):
            out = runner.run(idx[step:step + 1], step)
            rec.take()
            for k in losses:
                losses[k] += [float(v) for v in out[k]]
            if step == 0:
                b1 = state.optimizer.b1
                grad = {k: float(m.float().norm()) / (1.0 - b1) for k, m in state.optimizer.m.items()}
    change = {k: float((v.detach() - start[k]).float().norm()) for k, v in state.model.named_parameters()}
    del runner, cache, state, start
    device.empty_cache(dev)
    return {**losses, "grad": grad, "change": change, "tree": root}


def one_seed(cell, seed: int) -> dict:
    """One seed's row: the choices that differ at each checked step, and the
    compared numbers as is and with the program's choices replayed."""
    work = tempfile.mkdtemp(prefix="port_bench_choices_")
    try:
        ctx = cli.Ctx(cell, seed, 0.0, False, time.perf_counter(), work, lambda m: print(m, file=sys.stderr))
        generator = registry.load_generator(cell.generator)
        rec = Recorder()
        program = program_steps(ctx, generator, rec)
        cfg, p, dev = cell.config, cell.params, device.cuda_or_cpu()
        rows = reference.epoch_rows(p["images"], cfg["train"]["batch_size"], seed)[:p["check_steps"]]
        ref_rec = Recorder()
        with _reference_sites(rec=ref_rec):
            ref = reference.train_steps(cfg, seed, program["tree"], rows, dev)
        with _reference_sites(replay=rec.steps):
            replayed = reference.train_steps(cfg, seed, program["tree"], rows, dev)
        ref_steps = _split(ref_rec, len(rows))
        top = lambda r, key: [[k, round(g, 5)] for k, g, _, _ in compare.worst_leaves(program, r, key, 3)]
        return {"cell": cell.name, "seed": seed, "dtype": cfg["train"]["compute_dtype"],
                "differ": [differ(a, b) for a, b in zip(rec.steps, ref_steps)],
                "as_is": compare.train_numbers(program, ref), "replayed": compare.train_numbers(program, replayed),
                "worst_change": {"as_is": top(ref, "change"), "replayed": top(replayed, "change")},
                "worst_grad": {"as_is": top(ref, "grad"), "replayed": top(replayed, "grad")}}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--float32", action="store_true", help="both sides in float32")
    p.add_argument("--out", help="also append the JSON lines here")
    args = p.parse_args()
    cell = registry.load_cell(args.workload)
    if args.float32:
        config = copy.deepcopy(cell.config)
        config["train"]["compute_dtype"] = "float32"
        cell = dataclasses.replace(cell, config=config)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = one_seed(cell, seed)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
