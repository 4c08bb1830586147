"""Drive the PyTorch port on one NVIDIA GPU: its DESTR training step at
hidden width 256 and 512, its validation sweep, checkpoints, resume and
evaluator, its head-major flash-attention API, its L1-cost matcher and its
serving path; SSD300's serving, training, validation and the batch CLI;
training on image files with the JAX package's options (letterbox,
gradient accumulation, bfloat16 moments, optimizer layouts, remat);
training and serving from torch weights, and the captured step profiled by
kernel; data-parallel training over explicit process groups; the JAX
package's tools on the port (val noise, the divergence post-mortem, the
flash probe, the loader bench, the convolution roofline); and hold each
hand-written CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):
  1. device: require CUDA, print the card's name and power limit, turn TF32
     off for matmuls and convolutions;
  2. build: compile the four csrc/*.cu files (and the measurement copy of
     #2) with nvcc at once (timed); the fused backward's shared-memory size
     as the library counts it equal to its Python mirror (which plans the
     backward), and the plan of each call site printed;
  3. flash attention, kernels #1-#4 against their plain versions: the
     training step's three call-site shapes at hidden 256 and at hidden 512
     (B=16, float32 and bfloat16, dropout 0 and 0.3, masked as on the path;
     forward, the kernel's own keep mask read off its output, equal to the
     plain Philox mask with a kept share within 0.005 of 0.7; backward by
     the plan's kernels, #2 or the two-pass #3 + #4, with dQ / dK / dV
     errors relative to each tensor's largest value; a fully masked batch
     entry in the float32 dropout-0 cells of the wide cross-attention), the
     hidden-256 sites again with the two-pass kernels held against #2 on the
     same inputs, the Sk=7056 shapes at B=1 (backward), and slice 1's forward
     cells plus the wide cross-attention's (device times from CUDA-graph
     replay); times of the kernels, their plain versions and
     F.scaled_dot_product_attention (a yardstick, never on the path), and
     the bound from bytes and operations. #1 runs on the tensor cores in
     both dtypes (float32 in 3xTF32), #2-#4 in bfloat16 (their float32 on
     the CUDA cores): for the bfloat16 step cells of
     both widths, the device times (CUDA-graph replay) of #1 and of #2, or
     #3 and #4 where the plan runs them, at dropout 0 and 0.3 side by side,
     beside their eager times, their plain versions', their bounds, SDPA's
     and the replaced CUDA-core kernels' recorded times (PERF.md; not
     measured here); #3's and #4's errors at both cross sites; and #2's
     gradient errors with its hi / lo bf16 pairs and with one bf16 for dS
     and P keep (a copy of #2 built for that measurement only, with
     -DODTT_FLASH_BWD_ONE_BF16);
  3a. the head-major (B, h, S, d) kernels #5 (forward), #6 (dQ) and #7
     (dK / dV) against their plain versions at the call-site shapes of both
     widths (B=16, float32 and bfloat16, dropout 0 and 0.3, masked as on the
     path) and at Sk=7056 (B=1), each bit-equal to #1 / #3 / #4 on the same
     logical inputs in the packed layout; times beside the plain versions,
     SDPA (which takes this layout) and the bound;
  3b. the head-major public API, flash_attention and
     flash_attention_trainable, on (B, S, h, d) views at those shapes:
     exactly one #5 launch a call and one #6 and #7 a backward;
  3c. the dropout seed in device memory: a draw of the training stream's
     seed and kernel #1 captured in a CUDA graph, replayed at two steps
     after reseeding the registered generator: each replay's seed and keep
     mask equal the eager draw's at that step and the plain Philox mask, and
     the two steps' masks differ;
  4. fused cost + auction, kernel #9 against its plain version: 32 problems
     of N=400 rows and T=300 columns as the training step stacks them, with
     at most 8 valid targets (the synthetic recipe) and with 150-300 (dense);
     rows duplicate-free, equal or a near-tie within T*eps of the plain
     total, and within T*eps of scipy's optimum where the auction converged
     before its 256-round cap; in the synthetic setting rows, rounds and
     bids equal to the plain version's, also with the rounds capped at 1, 2
     and 4 (valid columns left to the greedy completion) and with fewer real
     rows than columns on some problems; the kernel's time alone on the
     device (CUDA graph of the launch on prepared operands) beside the
     wrapper's (with its PyTorch prologue) on the device and eager; the
     bound from the inputs, the bids' value rows over a long-window L2 read
     rate, and the cost's operations;
  5. the L1-cost matcher, kernel #8 against its plain version:
     losses.matcher.hungarian_match(cost_bbox=2.5) on 16 problems of the
     model's 300 queries and of the mini-detector's 400 tokens, T=300, sparse
     and dense targets, and set_criterion(rows=None, cost_bbox=2.5): one #8
     launch a call, rows checked as in phase 4, rounds and bids equal to the
     plain solver's in the synthetic setting;
  6. the training path: train.train.main with the production recipe
     (synthetic 672px canvases, 640px, batch 16, bf16, 6+6 blocks, top_k 300,
     dropout 0.3, boxes-normalized class loss, L1 weight 2.5, clip 0.1,
     skip-non-finite 100, lr 1e-4 / 1e-5, warmup) for 4 steps, with an empty
     validation split and its _last checkpoint in a temporary directory: finite losses,
     updated parameters, exactly 18 / 18 / 0 / 0 / 1 launches of #1 / #2 /
     #3 / #4 / #9 a step, the median step time from CUDA events after the
     first step; then three more steps of the same train step with CUDA
     events around its parts; the same with --hidden_dim 512, 18 / 12 / 6 /
     6 / 1 launches a step (the cross-attention's backward is two-pass);
  6a. the captured step at both widths on device-cached batches: the epoch
     runner takes step 0 (eager warm-up, CUDA-graph capture); at each of
     steps 1-4, from one cloned state, five eager steps (the first once
     under torch.cuda.set_sync_debug_mode("error")), a replay with the
     step's seeds and a replay with the capture's seeds (a planted fault):
     the replay's Adam first moment and parameters (relative to the step's
     change) and its 4 steps' losses no farther from the eager samples' mean
     than the largest distance between two eager samples, the planted fault
     farther; step times (CUDA events) eager and captured in turns; a
     torch.profiler window of 3 steps of each: the device's busy time and
     idle share and the launches a step read from the trace (18 / 18 / 0 /
     0 / 1 and 18 / 12 / 6 / 6 / 1 of #1 / #2 / #3 / #4 / #9); peak memory
     of each;
  6b. the validation path: train.train.main with the production recipe, a
     32-image validation split, --ema_decay 0.999, --coco_eval and
     checkpoints for 4 steps: exactly 18 / 18 / 0 / 0 / 1 launches of #1 /
     #2 / #3 / #4 / #9 a step and 18 of #1 and 1 of #9 a validation batch
     (live and EMA sweeps, 2 batches each); smoke, smoke_ema and smoke_last
     written; infer.evaluate.main on smoke reproduces the driver's mAP within
     1e-6; a resume from smoke_last runs steps 5-8; the eval step's time a
     batch, the sweep's images/s, the EMA update and a checkpoint's size and
     write time;
  6c. train.train.main with --device_cache --epoch_scan, 2 epochs on 64
     samples, against five --device_cache runs (the per-step path, the
     first with --profile_dir): final parameters and logged losses no
     farther from the per-step runs' mean than two per-step runs are apart,
     the profile's trace parsed (steps 2 and 3, the traced range 2-4 cut by
     the 4-step epoch; 18 / 18 / 0 / 0 / 1 launches a step), the cache's
     bytes and build time;
  7. one whole train step, kernels against plain versions: B=4, float32,
     dropout 0, the same weights and batch, at hidden 256 and 512; the
     kernel run's discrete choices (pairs, top-k indices, matcher rows) must
     be near-ties where the plain run's differ and are then replayed in it;
     loss, gradients and updated parameters compared;
  8. serving at full width: build_service captures the predict (its
     warm-up and capture call #1's wrapper 18 times each), 8 requests as
     graph replays and the same 8 with the model run eagerly, the
     detections equal; latencies of both; a torch.profiler trace of 4
     requests of each: 18 #1 launches a request, device busy time, idle
     share;
  9. whole model forward, kernel against plain, discrete choices
     (top-k, pairs) recorded and replayed as in phase 7;
 10. serve-ssd-300: build_service --model ssd (seeded random weights, the
     B=1 predict captured), 8 requests of four aspect ratios as replays and
     eagerly, the detections equal; latencies, a trace of 4 requests of each
     (device busy time, idle share); the float32 forward against the CPU's
     (1e-4 of each head's largest value);
 11. cli: infer.cli.predict_arrays on the card for DESTR (phase 8's
     service) and SSD, each image's detections equal to the captured
     server's (labels, counts; boxes and scores within 1e-5);
 12. train-ssd-300: scripts/train_prod_ssd.sh's recipe (B=32, 300px, bf16,
     20 classes, paper mining, lr 1e-4, warmup 500, skip-non-finite 100) on
     a 256-image device cache: phase 6a's captured-against-eager check
     through the EpochRunner (five eager steps from one cloned state at each
     of steps 1-4, the planted fault of step 0's augmentation seeds) with
     cuDNN held to deterministic engines, where the eager samples are
     bit-equal and so must the replay be; the step captured again with
     cuDNN's default engines, its replay's losses equal to an eager step's;
     that capture's step times, idle shares, peak memory; the eager step's parts (forward,
     criterion, backward, the frozen VGG trunk's share of it, optimizer; the
     criterion alone, forward and backward); ssd_criterion on the card
     against the CPU's (1e-4 relative);
 13. validate-ssd: train_ssd.main with --device_cache --epoch_scan, the EMA
     and a 64-image validation split, 4 steps; infer.evaluate --model ssd
     reproduces the driver's mAP (1e-6) and validation loss; a resume goes
     on from step 4 to 8. Phases 10-13 count the nine kernels' launches
     from zero: SSD's path launches none of them.
 14. train-real-data: (a) a WIDER FACE tree written in a temporary
     directory (64 + 16 seeded JPEGs 1024 wide and 0.5-1.5 as tall, 1-40
     faces each, a 0-count entry a split); (b) the loader's native pool
     (the fused JPEG decode where libjpeg's headers let it build, else PIL's
     decode and the native resize; which, printed) against PIL + cv2 on 16
     of them at the 672 canvas, 99th percentile of the difference at most 2
     grey levels, host images/s of both and of the letterbox path; (c)
     train.train.main --dataset widerface --letterbox --grad_accum_steps 2
     --moment_dtype bfloat16 --opt_layout grouped --rng_impl threefry at the
     production width, one epoch (4 mini-steps, 2 updates) and its
     validation batch, eager and with --device_cache --epoch_scan: launches
     18 / 18 / 1 of #1 / #2 / #9 a mini-step and 18 / 0 / 1 a validation
     batch, moments bfloat16, TensorBoard events; mini-steps 1 and 2 from a
     fresh state (parameters held, then moved); (e) one float32 update of
     each optimizer layout from one state, the parameters bit-equal, and the
     update's time by layout and moment dtype; (d) DestrConfig(remat=True):
     one micro-step's gradients within five micro-steps' spread without
     remat, a planted fault (the recomputation drawing new dropout masks)
     outside it, 36 / 18 / 1 launches a micro-step with remat (18 / 18 / 1
     without), eager and from a trace of the captured step, peak memory
     below the one without remat, step times; then phase 6a's check on this
     recipe: each replayed mini-step within five eager ones' spread (the
     accumulator held where a mini-step updates nothing), step times, idle
     shares, launches from a trace, peak memory.
 15. import: (a) a torchvision-layout ResNet-50 (tools/ref_torch_models.py,
     seeded, BN statistics randomized) written as .npz and .pth, each
     through models.import_weights.main at the default full width: the two
     checkpoints equal, the backbone bit-equal to resnet_params_from_torch;
     the imported backbone on the card against TorchResNet (2 images
     640x640, float32, TF32 off, each stage within 1e-4 of its largest
     value); train.main --resume --resume_from pretrained, 2 steps of the
     production recipe: 18 / 18 / 1 launches of #1 / #2 / #9 a step,
     finite losses, the stem, layer1 and every FrozenBN tensor held and
     every layer2-4 conv moved; (b) torch_vgg16_features through
     import_weights --model ssd, conv4_3 against it at 300 px (1e-4),
     train_ssd.main --resume for 2 steps, none of the nine kernels, the
     trunk bit-equal to the import; (c) a seeded full-width DESTR and SSD
     written in the reference's key layout (tests/reference_layout.py),
     destr_variables_from_torch / ssd_variables_from_torch,
     save_variables_npz, build_service --weights ref_*.npz: the served
     weights bit-equal to the source, 4 requests each against the source
     model's own predict (labels and counts equal, boxes and scores within
     1e-5), #1 18 times a traced request; (d) tools/profile_step_torch.py's
     main in this process (3 captured steps, B=16, 640 px): 18 / 18 / 1
     launches of #1 / #2 / #9 a step from the trace, the kernels' summed
     time a step within 5 % above the device's busy time; its table and
     top 10 kernels printed, each line beside the card's name and power.
 16. data parallelism (parallel/mesh.py; multi-GPU throughput is not
     measured: the machine has one card): (a) the DESTR recipe (hidden 256,
     B=16, 640 px, bf16, dropout 0.3) and the SSD recipe (B=32, 300 px) over
     an explicit 1-rank NCCL mesh (its BatchNorms synced, its gradient,
     criterion and BatchNorm all-reduces in the graph), captured by the
     epoch runner: at 2 steps, from one cloned state, the replay within 3
     eager no-mesh steps' spread (SSD with cuDNN held to deterministic
     engines, so bit-equal); captured step times with and without the mesh
     in turns; a trace of 3 mesh replays: 18 / 18 / 1 launches of #1 / #2 /
     #9 a step (SSD none), the NCCL kernels' device time; (b) two gloo
     thread-ranks on the card, each on its own stream, eager, DESTR at full
     width in float32, global B=16 (8 a rank), dropout 0, 2 steps, against one process
     on the same weights and batches: parameters, losses and BatchNorm
     statistics bit-identical across ranks, near one process's (DP_TOL),
     18 / 18 / 1 launches of #1 / #2 / #9 a rank-step counted by stream.
 17. tools (the JAX package's tools/ on the port, each from its
     tools/*_torch.py in this process): (a) val_noise on phase 6b's best
     checkpoint (32 images, 2 valid-loader orders, 200 resamples): the
     metric state the same in both orders, the per-image rows summing back
     to the sweep's mAP and COCO AP, 18 #1 and 1 #9 launches a batch; (b)
     the production recipe (hidden 256, B=16, bf16, dropout 0.3) trained an
     epoch of 2 steps to pm_last and resumed from it 4 times for 2 more,
     logging every step; postmortem_divergence replays those 2 steps from
     pm_last: its first step's losses equal to every resume's (1e-6, the
     log's rounding), its losses no farther from the nearest resume's than
     twice the largest gap between two resumes plus 1e-6 (kernel #2's
     atomic dQ makes no two runs of a later step bit-equal, and the next
     step's discrete choices amplify that), 18 / 18 / 1 launches of #1 /
     #2 / #9 a step; (c) probe_flash at its defaults (Sq = Sk = 7056, B=1, 8 heads
     of 32, dropout 0.1): #1 and #1 + #2 device times against their bound
     and SDPA's; (d) bench_loader on 256 written 600x800 JPEGs (COCO
     layout); (e) roofline_conv at B=16, 640 px against the convolution
     category of phase 15 (d)'s trace.

The line before the last lists the kernels as JSON (#1-#4 also with
their device times at dropout 0 and 0.3, #2's split errors and #3's and
#4's errors at both cross sites; #1's serving entry with its float32 B=1
sites; #8's and #9's rounds and bids beside the plain version's); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import shutil
import tempfile
import threading
import time
import traceback
import urllib.request

F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12  # H100 SXM dense bfloat16 tensor-core FLOP/s
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s
# float32-accurate products on the tensor cores: three TF32 products each
# (3xTF32), the fastest float32 rate the card offers, so the bound of float32
# attention (not the 67 TFLOP/s of the CUDA cores)
F32_3XTF32_PEAK = TF32_PEAK / 3
HBM_RATE = 3.35e12  # H100 SXM bytes/s
TOL = {"float32": 5e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# float operations of one (target, row) entry of #9's value matrix: the pairwise
# IoU, enclosing-box, centre, aspect and cost terms of csrc/auction.cu (48; the
# per-box terms are counted once per box, i.e. not at all) and the range (2)
AUCTION_PAIR_OPS = 50
# (name, Sq, Sk, heads, d, dv, masked on the path)
SITES = [
    ("encoder_self", 400, 400, 8, 32, 32, True),
    ("decoder_self", 300, 300, 8, 64, 64, False),
    ("cross_cls_reg", 600, 400, 1, 512, 256, True),
    ("encoder_self_7056", 7056, 7056, 8, 32, 32, True),
    ("cross_cls_reg_7056", 600, 7056, 1, 512, 256, True),
]
PATH_SITES = SITES[:3]
# the same call sites with --hidden_dim 512: d = C / 8 and 2C / 8, and the
# merged cross-attention's d = 2C, dv = C
WIDE_SITES = [
    ("encoder_self_wide", 400, 400, 8, 64, 64, True),
    ("decoder_self_wide", 300, 300, 8, 128, 128, False),
    ("cross_cls_reg_wide", 600, 400, 1, 1024, 512, True),
]
WIDE_CROSS = WIDE_SITES[2]
WIDE_LONG = ("cross_cls_reg_wide_7056", 600, 7056, 1, 1024, 512, True)
BLOCKS = 6  # encoder and decoder blocks of the served and trained model
TRAIN_B = 16
RATE = 0.3
REQUEST_SIZES = [(480, 640), (640, 480), (640, 640), (500, 333)]  # (H, W)
PKG = "object_detection_destr_tpu_torch"
TRAIN_STEPS = 4
TRAIN_ARGS = [
    "--dataset", "synthetic", "--synthetic_size", "672", "--num_train_samples", str(TRAIN_B * TRAIN_STEPS),
    "--augment_factor", "1", "--image_size", "640", "--batch_size", str(TRAIN_B),
    "--compute_dtype", "bfloat16", "--num_encoder_blocks", "6", "--num_decoder_blocks", "6",
    "--top_k", "300", "--epochs", "1", "--lr", "1e-4", "--lr_backbone", "1e-5", "--lr_drop", "90",
    "--lr_warmup_steps", "1000", "--class_norm", "boxes", "--set_cost_class", "1",
    "--set_cost_bbox", "2.5", "--set_cost_ciou", "1", "--grad_clip_norm", "0.1",
    "--skip_nonfinite", "100", "--log_interval", "1",
]
WIDE_ARGS = ["--hidden_dim", "512"]
# eager ms a launch of the CUDA-core kernels #1-#4 that the bfloat16
# tensor-core kernels replaced (B=16, bfloat16, dropout 0.3), as PERF.md's
# kernel table records them (this script on an NVIDIA H100 80GB HBM3,
# 700.00 W): printed beside this run's times, never measured by this run and
# never in its kernels line
CUDA_CORE_RECORDED_MS = {
    "fwd": {"encoder_self": 0.7182, "decoder_self": 0.5253, "cross_cls_reg": 1.3398,
            "encoder_self_wide": 0.9167, "decoder_self_wide": 0.8280, "cross_cls_reg_wide": 6.1622},
    "bwd": {"encoder_self": 1.3830, "decoder_self": 3.4025, "cross_cls_reg": 3.5030,
            "encoder_self_wide": 5.6720, "decoder_self_wide": 6.8773},
    "dq": {"cross_cls_reg_wide": 9.1328},
    "dkv": {"cross_cls_reg_wide": 12.7446},
    # serving: B=1, float32, masked as on the path, device time (CUDA graph),
    # the CUDA-core float32 kernel the 3xTF32 one replaced
    "fwd_f32_b1": {"encoder_self": 0.0553, "decoder_self": 0.0569, "cross_cls_reg": 0.2450},
}
# the auction kernels before their compacted-column solver, eager ms of the
# wrapper's call (PERF.md; this script, NVIDIA H100 80GB HBM3, 700.00 W):
# printed beside this run's times, never measured by this run
AUCTION_RECORDED_MS = {"fused_auction": {"synthetic": 0.7353, "dense": 2.0241},
                       "auction_assignment": {"synthetic": 0.3735}}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(torch, fn, reps=None, warmup=2) -> float:
    """Median milliseconds of one eager call, from CUDA events after warm-up
    (the host's launch time is inside when it exceeds the device's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if reps is None:
        reps = int(min(20, max(3, 300.0 / max(_event_ms(torch, fn), 1e-3))))
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _event_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(torch, fn, reps=5) -> float:
    """Median device milliseconds of one call: several calls captured in one
    CUDA graph and replayed between two CUDA events, so no host launch time
    is counted. Warm up with ``fn`` before."""
    calls = int(min(20, max(1, 5.0 / max(_event_ms(torch, fn), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    del graph
    return statistics.median(s.elapsed_time(e) for s, e in times) / calls


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)  # name, power limit: every time below is taken on this card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return card


def phase_build(libraries) -> None:
    from object_detection_destr_tpu_torch.ops.cuda.build import build_all

    start = time.perf_counter()
    seconds = build_all(libraries)
    log(f"build: {', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())} "
        f"(in parallel, {time.perf_counter() - start:.1f} s)")
    for lib in libraries:
        lib.library()
        for kernel, registers, spilled in ptxas_usage(lib.build_log):
            log(f"  ptxas {lib.name}: {kernel}: {registers} registers, {spilled} bytes spilled")


def ptxas_usage(build_log):
    """(kernel with its template arguments, registers, spill-store bytes) of
    each entry function in nvcc's -Xptxas -v output."""
    import re

    usage, kernel, spilled = [], None, 0
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            # an Itanium-mangled name: <length><identifier>, the kernel's the one ending in _kernel
            # (a length may follow a hash's digits, so every tail of a digit run is tried)
            names = [mangled[m.end():m.end() + int(m.group()[i:])] for m in re.finditer(r"\d+", mangled)
                     for i in range(len(m.group()))]
            names = [n for n in names if n.endswith("_kernel") and n[0].isalpha()]
            args = re.findall(r"Li(\d+)E", mangled)
            kernel = (names[-1] if names else mangled) + (f"<{', '.join(args)}>" if args else "")
            spilled = 0
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            spilled = int(spill.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel:
            usage.append((kernel, int(used.group(1)), spilled))
            kernel = None
    return usage


def phase_plan(torch, fa) -> None:
    """The fused backward's shared memory as its library counts it equals
    the Python mirror that plans the backward; the plan of each call site on
    this card."""
    lib = fa.BWD_LIBRARY.library()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for d, dv in [(32, 32), (64, 64), (128, 128), (512, 256), (512, 512), (1024, 512)]:
        for itemsize in (4, 2):
            counted, mirrored = lib.odtt_flash_bwd_smem_bytes(d, dv, itemsize), fa.fused_backward_smem_bytes(d, dv, itemsize)
            if counted != mirrored:
                raise AssertionError(f"fused backward at d={d} dv={dv} itemsize={itemsize}: the library counts "
                                     f"{counted} bytes of shared memory, the plan's mirror {mirrored}")
    plans = {name: {str(dt).split(".")[-1]: fa.backward_plan(d, dv, dt, optin) for dt in (torch.float32, torch.bfloat16)}
             for name, _, _, _, d, dv, _ in PATH_SITES + WIDE_SITES}
    want = {name: "two_pass" if name == WIDE_CROSS[0] else "fused" for name in plans}
    if any(set(p.values()) != {want[name]} for name, p in plans.items()):
        raise AssertionError(f"backward plans {plans}, expected {want}")
    log(f"plan: {optin} bytes of shared memory a block (opt-in); the fused backward's layout equals the library's "
        f"count at 12 widths; backward by call site {plans}")


def warm_clocks(torch) -> None:
    x = torch.randn(4096, 4096, device="cuda")
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        x = torch.tanh(x @ x)
        torch.cuda.synchronize()


def bound_ms(b, sq, sk, h, d, dv, itemsize, masked, dtype_name, kind="fwd"):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the peak for the operand type. Per head, with each
    input read once and each output written once:
      fwd: q, k, v (and the mask) in, out and lse out; 2*Sq*Sk*(d + dv)
           FLOPs (s, p v);
      bwd (#2): q, k, v, out, dO, lse (and the mask) in, dQ, dK, dV out;
           2*Sq*Sk*(3d + 2dv) FLOPs (s recomputed, dp, dV, dQ, dK);
      dq (#3): the same inputs, dQ out; 2*Sq*Sk*(2d + dv) (s, dp, dQ);
      dkv (#4): the same inputs, dK, dV out; 2*Sq*Sk*(2d + 2dv) (s, dp,
           dK, dV).
    The operations' peak: bfloat16 989 TFLOP/s, float32 495 / 3 (3xTF32)."""
    q, k, v, o = b * sq * h * d, b * sk * h * d, b * sk * h * dv, b * sq * h * dv
    grads_out, per_pair = {"fwd": (o, d + dv), "bwd": (q + k + v, 3 * d + 2 * dv),
                           "dq": (q, 2 * d + dv), "dkv": (k + v, 2 * d + 2 * dv)}[kind]
    ins = q + k + v + (0 if kind == "fwd" else 2 * o)  # out and dO in for the backward
    nbytes = itemsize * (ins + grads_out) + 4 * b * h * sq  # lse out (fwd) or in
    nbytes += b * sk if masked else 0
    flops = 2 * b * h * sq * sk * per_pair
    peak = F32_3XTF32_PEAK if dtype_name == "float32" else BF16_PEAK
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30)).item()


def keep_mask_operands(torch, b, sq, sk, h, d, dv, dtype):
    """q = k = 0 and the slices of the Sk x Sk identity that
    :func:`kernel_keep_mask` reads a keep mask with: (q, k, [(off, w, v)])."""
    q = torch.zeros(b, sq, h * d, device="cuda", dtype=dtype)
    k = torch.zeros(b, sk, h * d, device="cuda", dtype=dtype)
    slices = []
    for off in range(0, sk, dv):
        w = min(dv, sk - off)
        v = torch.zeros(b, sk, h, dv, device="cuda", dtype=dtype)
        cols = torch.arange(w, device="cuda")
        v[:, off + cols, :, cols] = 1
        slices.append((off, w, v.view(b, sk, h * dv)))
    return q, k, slices


def kernel_keep_mask(torch, fa, b, sq, sk, h, d, dv, dtype, rate, seed, operands=None):
    """The keep mask that kernel #1 draws, read off its output: with q = k = 0
    every key weighs 1/Sk, so with v a slice of the Sk x Sk identity, out[...,
    c] = keep[..., off + c] / ((1 - rate) Sk). ceil(Sk / dv) launches of the
    call site's shape on :func:`keep_mask_operands` (made here unless
    given); (B, h, Sq, Sk) bool."""
    q, k, slices = operands or keep_mask_operands(torch, b, sq, sk, h, d, dv, dtype)
    keep = torch.empty(b, sq, h, sk, dtype=torch.bool, device="cuda")
    for off, w, v in slices:
        out, _ = fa.flash_attention_fwd(q, k, v, h, None, None, rate, seed)
        keep[..., off:off + w] = out.view(b, sq, h, dv)[..., :w].float() * ((1.0 - rate) * sk) > 0.5
    return keep.permute(0, 2, 1, 3)


def flash_cell(torch, gen, site, b, dtype, rate, masked, backward, graph_timing, fully_masked_entry=False):
    """One shape cell of kernel #1 against its plain version and, with
    ``backward``, of the backward the plan picks for the card ("plan"),
    kernel #2 ("fused"), kernels #3 + #4 ("two_pass"), or both, then also
    held against each other ("both"). The plain forward runs one batch
    entry at a time where its (B, h, Sq, Sk) scores would pass 2 GiB (no
    dropout there). ``fully_masked_entry`` masks every key of batch entry 0."""
    import torch.nn.functional as F

    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    name, sq, sk, h, d, dv, _ = site
    dname = str(dtype).split(".")[-1]
    q = torch.randn(b, sq, h * d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, h * d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, h * dv, generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        lengths = torch.randint(sk * 3 // 4, sk + 1, (b,), generator=gen, device="cuda")
        if fully_masked_entry:
            lengths[0] = 0
        mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
    seed = 1234 if rate else None
    chunked = b * h * sq * sk * 4 > (2 << 30)
    assert not (chunked and (rate or backward))

    def plain():
        if not chunked:
            return fa.flash_attention_packed_reference(q, k, v, h, mask, None, rate, seed)
        parts = [fa.flash_attention_packed_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1], h,
                                                     None if mask is None else mask[i:i + 1])
                 for i in range(b)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    out, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, rate, seed)
    ref_out, ref_lse = plain()
    torch.cuda.synchronize()
    row = dict(site=name, b=b, dtype=dname, rate=rate, masked=masked, fully_masked_entry=fully_masked_entry)
    row["max_abs_err"] = (out.float() - ref_out.float()).abs().max().item()
    row["rel_err"] = _rel(out, ref_out)
    row["lse_err"] = (lse - ref_lse).abs().max().item() / max(ref_lse.abs().max().item(), 1.0)
    ok = row["rel_err"] <= TOL[dname] and row["lse_err"] <= TOL[dname] and bool(torch.isfinite(out).all())
    del ref_out, ref_lse
    if rate:  # the kernel's own draws: their share, and bit for bit the plain mask
        keep = kernel_keep_mask(torch, fa, b, sq, sk, h, d, dv, dtype, rate, seed)
        row["kept"] = keep.float().mean().item()
        row["keep_equal"] = torch.equal(keep, fa._keep_mask(seed, rate, b, h, sq, sk, "cuda"))
        ok = ok and row["keep_equal"] and abs(row["kept"] - (1.0 - rate)) <= 0.005
        del keep

    qh = q.view(b, sq, h, d).transpose(1, 2)
    kh = k.view(b, sk, h, d).transpose(1, 2)
    vh = v.view(b, sk, h, dv).transpose(1, 2)
    bias = None
    if mask is not None:
        bias = torch.zeros(b, 1, 1, sk, device="cuda", dtype=dtype)
        bias.masked_fill_(~mask[:, None, None, :], -1e9)
    timer = device_ms if graph_timing else time_cuda
    row["ms"] = timer(torch, lambda: fa.flash_attention_fwd(q, k, v, h, mask, None, rate, seed))
    if graph_timing:
        time_cuda(torch, plain, reps=1)  # warm the allocator outside the graph
    row["plain_ms"] = timer(torch, plain)
    try:
        row["library_ms"] = timer(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias, dropout_p=rate))
    except torch.cuda.OutOfMemoryError:
        row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = bound_ms(b, sq, sk, h, d, dv, q.element_size(), masked, dname)

    if backward:
        optin = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
        plan = fa.backward_plan(d, dv, dtype, optin) if backward == "plan" else backward
        row["bwd_plan"] = plan
        dout = torch.randn(b, sq, h * dv, generator=gen, device="cuda").to(dtype)
        args = (q, k, v, h, mask, out, lse, dout, None, rate, seed)
        runs = {}
        if plan in ("fused", "both"):
            runs["fused"] = fa.flash_attention_bwd(*args)
        if plan in ("two_pass", "both"):
            runs["two_pass"] = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
        ref = fa.flash_attention_packed_backward_reference(*args)
        torch.cuda.synchronize()
        row["bwd_rel_err"] = {f"{kind} {n}": _rel(g, r) for kind, grads in runs.items()
                              for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
        row["bwd_abs_err"] = {f"{kind} {n}": (g.float() - r.float()).abs().max().item() for kind, grads in runs.items()
                              for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
        errs = list(row["bwd_rel_err"].values())
        if plan == "both":  # the two-pass kernels against #2 on the same inputs
            row["two_pass_vs_fused"] = {n: _rel(g, f) for n, g, f in zip(("dq", "dk", "dv"), runs["two_pass"],
                                                                          runs["fused"])}
            errs += list(row["two_pass_vs_fused"].values())
        ok = ok and max(errs) <= BWD_TOL[dname] and all(
            bool(torch.isfinite(g).all()) for grads in runs.values() for g in grads)
        del ref, runs
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
        doh = dout.view(b, sq, h, dv).transpose(1, 2)

        def library_fwd_bwd():
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias, dropout_p=rate).backward(doh)

        itemsize = q.element_size()
        timed = {"bwd": (fa.flash_attention_bwd, fa.flash_attention_packed_backward_reference),
                 "dq": (fa.flash_attention_dq, fa.flash_attention_dq_reference),
                 "dkv": (fa.flash_attention_dkv, fa.flash_attention_dkv_reference)}
        kinds = {"fused": ["bwd"], "two_pass": ["dq", "dkv"], "both": ["bwd", "dq", "dkv"]}[plan]
        for kind in kinds:
            kernel, reference = timed[kind]
            row[f"{kind}_ms"] = time_cuda(torch, lambda: kernel(*args))
            row[f"{kind}_plain_ms"] = time_cuda(torch, lambda: reference(*args))
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms(b, sq, sk, h, d, dv, itemsize, masked,
                                                                       dname, kind)
        row["bwd_library_ms"] = time_cuda(torch, library_fwd_bwd)
    row["ok"] = ok
    lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    msg = (f"flash {name:23s} B={b:<2d} {dname:8s} rate={rate} masked={int(masked)}"
           + (" (entry 0 fully masked)" if fully_masked_entry else "")
           + f" fwd rel_err={row['rel_err']:.2e} lse_err={row['lse_err']:.2e} ms={row['ms']:.4f} "
           f"plain_ms={row['plain_ms']:.4f} sdpa_ms={lib} bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
           + (" (device, CUDA graph)" if graph_timing else " (eager calls)"))
    if rate:
        msg += f" kernel kept={row['kept']:.5f} equal to the plain mask={row['keep_equal']}"
    if backward:
        msg += (f" | bwd {row['bwd_plan']} rel_err " + " ".join(f"{n}={e:.2e}" for n, e in row["bwd_rel_err"].items()))
        if "two_pass_vs_fused" in row:
            msg += " two-pass vs #2 " + " ".join(f"{n}={e:.2e}" for n, e in row["two_pass_vs_fused"].items())
        for kind in kinds:
            msg += (f" {kind}_ms={row[f'{kind}_ms']:.4f} plain_ms={row[f'{kind}_plain_ms']:.4f} "
                    f"bound_ms={row[f'{kind}_bound_ms']:.4f} ({row[f'{kind}_bound_by']})")
        msg += f" sdpa_fwd_bwd_ms={row['bwd_library_ms']:.4f}"
    log(msg + (" OK" if ok else " FAIL"))
    torch.cuda.empty_cache()
    return row


def phase_flash(torch, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for sites in (PATH_SITES, WIDE_SITES):  # the training step's cells at hidden 256 and 512
        for site in sites:
            for dtype in (torch.float32, torch.bfloat16):
                for rate in (0.0, RATE):
                    full = site is WIDE_CROSS and dtype is torch.float32 and not rate
                    rows.append(flash_cell(torch, gen, site, TRAIN_B, dtype, rate, site[-1], "plan", False, full))
    for site in PATH_SITES:  # the two-pass kernels against #2 where both run
        rows.append(flash_cell(torch, gen, site, TRAIN_B, torch.float32, 0.0, site[-1], "both", False, site[-1]))
        rows.append(flash_cell(torch, gen, site, TRAIN_B, torch.bfloat16, RATE, site[-1], "both", False))
    for site in SITES[3:] + [WIDE_LONG]:  # the dilated 1333px configuration's long keys, backward
        rows.append(flash_cell(torch, gen, site, 1, torch.float32, 0.0, True, "plan", False))
    for site in SITES:  # the forward cells of slice 1, serving's among them
        for b in (1, TRAIN_B):
            for dtype in (torch.float32, torch.bfloat16):
                for masked in (True, False):
                    rows.append(flash_cell(torch, gen, site, b, dtype, 0.0, masked, None, True))
    for dtype in (torch.float32, torch.bfloat16):  # #1 at the wide cross-attention
        rows.append(flash_cell(torch, gen, WIDE_CROSS, TRAIN_B, dtype, 0.0, True, None, True))
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} flash-attention cells out of tolerance: {failed[:2]}")
    return rows


def phase_dropout_share(torch, seed, flash_rows):
    """The bfloat16 step cells of the path sites at both widths (B=16,
    masked as on the path): the tensor-core #1, and #2 or #3 and #4 as the
    plan runs them, on the device alone (CUDA-graph replay of the wrappers'
    calls; #2's with its delta, dQ zeroing and cast, #3's and #4's with
    their delta) at dropout 0 and 0.3 side by side, so the Philox draws'
    share shows. Printed beside each kernel's eager time, its plain
    version's, its bound and SDPA's from phase 3, and the CUDA-core kernels'
    recorded eager times. Ms a launch by site."""
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    rows = []
    for name, sq, sk, h, d, dv, masked in PATH_SITES + WIDE_SITES:
        q, k, v, dout = (torch.randn(TRAIN_B, s, h * w, generator=gen, device="cuda").to(torch.bfloat16)
                         for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
        mask = None
        if masked:
            lengths = torch.randint(sk * 3 // 4, sk + 1, (TRAIN_B,), generator=gen, device="cuda")
            mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
        row = {"site": name, "fused": fa.backward_plan(d, dv, torch.bfloat16, optin) == "fused"}
        for rate in (0.0, RATE):
            seed_or_none = 1234 if rate else None
            out, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, rate, seed_or_none)
            row[f"fwd_ms_{rate}"] = device_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, h, mask, None, rate, seed_or_none))
            args = (q, k, v, h, mask, out, lse, dout, None, rate, seed_or_none)
            for kind, kernel in ((("bwd", fa.flash_attention_bwd),) if row["fused"] else
                                 (("dq", fa.flash_attention_dq), ("dkv", fa.flash_attention_dkv))):
                kernel(*args)
                row[f"{kind}_ms_{rate}"] = device_ms(torch, lambda: kernel(*args))
        eager = next(r for r in flash_rows if r["site"] == name and r["b"] == TRAIN_B and r["dtype"] == "bfloat16"
                     and r["rate"] == RATE and r.get("bwd_plan") in ("fused", "two_pass"))
        msg = (f"bf16 tensor cores {name:19s} #1 device ms rate 0 / {RATE}: {row['fwd_ms_0.0']:.4f} / "
               f"{row[f'fwd_ms_{RATE}']:.4f} (eager {eager['ms']:.4f}, SDPA eager {eager['library_ms']:.4f}; "
               f"CUDA-core kernel's recorded eager time {CUDA_CORE_RECORDED_MS['fwd'][name]:.4f}, not this run)")
        for kind, label in (("bwd", "#2"),) if row["fused"] else (("dq", "#3"), ("dkv", "#4")):
            msg += (f"; {label} device ms rate 0 / {RATE}: {row[f'{kind}_ms_0.0']:.4f} / "
                    f"{row[f'{kind}_ms_{RATE}']:.4f} (eager {eager[f'{kind}_ms']:.4f}, plain eager "
                    f"{eager[f'{kind}_plain_ms']:.4f}, bound {eager[f'{kind}_bound_ms']:.4f}, SDPA forward + backward "
                    f"eager {eager['bwd_library_ms']:.4f}; CUDA-core kernel's recorded eager time "
                    f"{CUDA_CORE_RECORDED_MS[kind][name]:.4f}, not this run)")
        log(msg)
        rows.append(row)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return rows


def one_bf16_backward(fa):
    """Kernel #2 built from the same source with -DODTT_FLASH_BWD_ONE_BF16,
    under its own library name: dS and P keep reach the tensor cores as one
    bf16 each instead of hi / lo pairs. Only :func:`phase_split` calls it,
    to measure what the pairs buy; the port never loads this build."""
    from object_detection_destr_tpu_torch.ops.cuda.build import CudaLibrary

    lib = fa.BWD_LIBRARY

    class OneBf16Backward(fa.FlashAttentionBackward):
        library = CudaLibrary(lib.name + "_one_bf16", lib.source, headers=lib.headers, functions=lib.functions,
                              abi=lib.abi, flags=[*lib.flags, "-DODTT_FLASH_BWD_ONE_BF16"])

    return OneBf16Backward()


def phase_split(torch, seed, one_bf16):
    """What #2's hi / lo bf16 pairs buy: at the bfloat16 sites where the
    plan runs #2 (B=16, dropout 0.3, masked as on the path), dQ / dK / dV
    errors relative to the plain version's largest value with the pairs (the
    kernel as it runs) and with one bf16 for dS and P keep (``one_bf16``,
    the measurement build)."""
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    rows = []
    for name, sq, sk, h, d, dv, masked in PATH_SITES + WIDE_SITES:
        if fa.backward_plan(d, dv, torch.bfloat16, optin) != "fused":
            continue
        q, k, v, dout = (torch.randn(TRAIN_B, s, h * w, generator=gen, device="cuda").to(torch.bfloat16)
                         for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
        mask = None
        if masked:
            lengths = torch.randint(sk * 3 // 4, sk + 1, (TRAIN_B,), generator=gen, device="cuda")
            mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
        out, lse = fa.flash_attention_fwd(q, k, v, h, mask, None, RATE, 99)
        args = (q, k, v, h, mask, out, lse, dout, None, RATE, 99)
        ref = fa.flash_attention_packed_backward_reference(*args)
        paired = fa.flash_attention_bwd(*args)
        single = one_bf16(*args)
        torch.cuda.synchronize()
        row = {"site": name, "paired": {n: _rel(g, r) for n, g, r in zip(("dq", "dk", "dv"), paired, ref)},
               "single": {n: _rel(g, r) for n, g, r in zip(("dq", "dk", "dv"), single, ref)}}
        rows.append(row)
        log(f"bf16 #2 {name:19s} rel_err with hi/lo pairs " + " ".join(f"{n}={e:.2e}" for n, e in row["paired"].items())
            + "; with one bf16 " + " ".join(f"{n}={e:.2e}" for n, e in row["single"].items()))
    return rows


def unpacked_cell(torch, gen, site, b, dtype, rate):
    """One (B, h, S, d) cell: kernel #5 against its plain version and #6 / #7
    (``flash_attention_unpacked_dq`` / ``_dkv``) against theirs, each also
    against the packed kernels (#1, #3, #4) on the same logical inputs
    transposed to (B, S, h*d): the same launches on other strides, so out,
    lse, dQ, dK and dV must be bit-equal. Masked as on the path."""
    import torch.nn.functional as F

    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    name, sq, sk, h, d, dv, masked = site
    dname = str(dtype).split(".")[-1]
    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, h, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, h, sk, dv, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(b, h, sq, dv, generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        lengths = torch.randint(sk * 3 // 4, sk + 1, (b,), generator=gen, device="cuda")
        mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
    seed = 4321 if rate else None
    out, lse = fa.flash_attention_unpacked_fwd(q, k, v, mask, None, rate, seed)
    args = (q, k, v, mask, out, lse, dout, None, rate, seed)
    grads = (fa.flash_attention_unpacked_dq(*args), *fa.flash_attention_unpacked_dkv(*args))
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask, None, rate, seed)
    ref_grads = (fa.flash_attention_unpacked_dq_reference(*args), *fa.flash_attention_unpacked_dkv_reference(*args))
    pk = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], -1).contiguous()
    p_out, p_lse = fa.flash_attention_fwd(pk(q), pk(k), pk(v), h, mask, None, rate, seed)
    p_args = (pk(q), pk(k), pk(v), h, mask, p_out, p_lse, pk(dout), None, rate, seed)
    p_grads = (fa.flash_attention_dq(*p_args), *fa.flash_attention_dkv(*p_args))
    torch.cuda.synchronize()
    row = dict(site=name, b=b, dtype=dname, rate=rate, masked=masked)
    row["max_abs_err"] = (out.float() - ref_out.float()).abs().max().item()
    row["rel_err"] = _rel(out, ref_out)
    row["lse_err"] = (lse - ref_lse).abs().max().item() / max(ref_lse.abs().max().item(), 1.0)
    row["bwd_rel_err"] = {n: _rel(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
    row["bwd_abs_err"] = {n: (g.float() - r.float()).abs().max().item()
                          for n, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
    unpack = lambda x, like: x.view(b, like.shape[2], h, -1).transpose(1, 2)
    row["equal_to_packed"] = {
        "out": torch.equal(out, unpack(p_out, out)), "lse": torch.equal(lse, p_lse),
        **{n: torch.equal(g, unpack(pg, g)) for n, g, pg in zip(("dq", "dk", "dv"), grads, p_grads)}}
    ok = (row["rel_err"] <= TOL[dname] and row["lse_err"] <= TOL[dname] and max(row["bwd_rel_err"].values())
          <= BWD_TOL[dname] and all(row["equal_to_packed"].values())
          and all(bool(torch.isfinite(t).all()) for t in (out, *grads)))
    del ref_out, ref_lse, ref_grads, p_out, p_lse, p_args, p_grads
    bias = None
    if mask is not None:
        bias = torch.zeros(b, 1, 1, sk, device="cuda", dtype=dtype)
        bias.masked_fill_(~mask[:, None, None, :], -1e9)
    itemsize = q.element_size()
    row["ms"] = time_cuda(torch, lambda: fa.flash_attention_unpacked_fwd(q, k, v, mask, None, rate, seed))
    row["plain_ms"] = time_cuda(torch, lambda: fa.flash_attention_reference(q, k, v, mask, None, rate, seed))
    row["library_ms"] = time_cuda(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                                dropout_p=rate))
    row["bound_ms"], row["bound_by"] = bound_ms(b, sq, sk, h, d, dv, itemsize, masked, dname)
    timed = {"dq": (fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dq_reference),
             "dkv": (fa.flash_attention_unpacked_dkv, fa.flash_attention_unpacked_dkv_reference)}
    for kind, (kernel, reference) in timed.items():
        row[f"{kind}_ms"] = time_cuda(torch, lambda: kernel(*args))
        row[f"{kind}_plain_ms"] = time_cuda(torch, lambda: reference(*args))
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms(b, sq, sk, h, d, dv, itemsize, masked, dname,
                                                                   kind)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    row["bwd_library_ms"] = time_cuda(torch, lambda: F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=bias, dropout_p=rate).backward(dout))
    row["ok"] = ok
    log(f"unpacked {name:23s} B={b:<2d} {dname:8s} rate={rate} masked={int(masked)} #5 rel_err={row['rel_err']:.2e} "
        f"lse_err={row['lse_err']:.2e} " + " ".join(f"#{6 if n == 'dq' else 7} {n}={e:.2e}"
                                                    for n, e in row["bwd_rel_err"].items())
        + f"; bit-equal to #1/#3/#4 on the packed layout {row['equal_to_packed']}; ms #5={row['ms']:.4f} "
        f"#6={row['dq_ms']:.4f} #7={row['dkv_ms']:.4f} plain_ms {row['plain_ms']:.4f} / {row['dq_plain_ms']:.4f} / "
        f"{row['dkv_plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} sdpa_fwd_bwd_ms={row['bwd_library_ms']:.4f} "
        f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}) / {row['dq_bound_ms']:.4f} / {row['dkv_bound_ms']:.4f} "
        f"(eager calls)" + (" OK" if ok else " FAIL"))
    torch.cuda.empty_cache()
    return row


def phase_unpacked(torch, seed):
    """Kernels #5-#7 at every call-site shape of both widths in (B, h, S, d)
    layout (B=16, float32 and bfloat16, dropout 0 and 0.3), and at the
    dilated 1333px encoder's Sk = 7056 (B=1, float32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    rows = []
    for site in PATH_SITES + WIDE_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, RATE):
                rows.append(unpacked_cell(torch, gen, site, TRAIN_B, dtype, rate))
    rows.append(unpacked_cell(torch, gen, SITES[3], 1, torch.float32, 0.0))
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} unpacked flash-attention cells out of tolerance: {failed[:2]}")
    return rows


def phase_unpacked_api(torch, kernels, seed):
    """The head-major public API, the path of #5-#7: at each call-site shape
    of both widths (B=16, bfloat16, dropout 0.3), ``flash_attention`` once
    and ``flash_attention_trainable`` forward and backward once, on
    (B, S, h, d) tensors viewed as (B, h, S, d), as a caller holding the
    modules' layout passes them. One #5 launch a call, one #6 and one #7 a
    backward, nothing else; the outputs and gradients equal the kernels'
    own on contiguous copies."""
    from object_detection_destr_tpu_torch.ops import flash_attention, flash_attention_trainable
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    sites = PATH_SITES + WIDE_SITES
    cases = []
    for name, sq, sk, h, d, dv, masked in sites:
        view = lambda s, w: torch.randn(TRAIN_B, s, h, w, generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        q, k, v, dout = view(sq, d), view(sk, d), view(sk, dv), view(sq, dv)
        lengths = torch.randint(sk * 3 // 4, sk + 1, (TRAIN_B,), generator=gen, device="cuda")
        mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None] if masked else None
        cases.append((q, k, v, dout, mask))
    reset_counts(kernels)  # the head-major API's path starts here
    results = []
    for q, k, v, dout, mask in cases:
        out_fwd = flash_attention(q, k, v, mask, 77, RATE)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_trainable(*leaves, mask, 77, RATE)
        out.backward(dout)
        results.append((out_fwd, out.detach(), [t.grad for t in leaves]))
    torch.cuda.synchronize()
    counts = [k.launches for k in kernels]  # read just after the path
    n = len(sites)
    want = [0, 0, 0, 0, 0, 0, 2 * n, n, n]
    if counts != want:
        raise AssertionError(f"the head-major API launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}")
    for (q, k, v, dout, mask), (out_fwd, out, grads) in zip(cases, results):
        c = [t.contiguous() for t in (q, k, v, dout)]
        ref, lse = fa.flash_attention_unpacked_fwd(c[0], c[1], c[2], mask, None, RATE, 77)
        args = (c[0], c[1], c[2], mask, ref, lse, c[3], None, RATE, 77)
        ref_grads = (fa.flash_attention_unpacked_dq(*args), *fa.flash_attention_unpacked_dkv(*args))
        if not (torch.equal(out_fwd, ref) and torch.equal(out, ref)
                and all(torch.equal(g, r) for g, r in zip(grads, ref_grads))):
            raise AssertionError("the head-major API on strided views differs from the kernels on copies")
    log(f"unpacked API: flash_attention + flash_attention_trainable (forward, backward) at {n} call-site shapes, "
        f"B={TRAIN_B}, bf16, dropout {RATE}, (B, S, h, d) views: launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}; "
        f"outputs and gradients bit-equal to the kernels on contiguous copies OK")
    return counts


def l2_rate(torch) -> float:
    """Bytes/s of reads served by the 50 MB L2: one reduction reads 64 rows of
    4 Mi float32 (1 GiB in one launch, so launch and tail are a small share
    of the window), each row starting 128 KB after the one before, so the
    rows span 24 MB and do not read one address at once (no L1 reuse);
    replayed from a CUDA graph; never below the HBM rate. The rate the
    auction's bids read value rows at."""
    n, rows, shift = 4 * 1024 * 1024, 64, 32 * 1024
    src = torch.randn(n + (rows - 1) * shift, device="cuda")
    view = src.as_strided((rows, n), (shift, 1))
    view.sum(1)
    ms = device_ms(torch, lambda: view.sum(1), reps=9)
    return max(view.numel() * 4 / (ms * 1e-3), HBM_RATE)


def auction_problems(torch, seed, dense):
    """32 problems (2 x 16: the model's 300 top-k queries padded to the
    mini-detector's 400 tokens, then the tokens), T=300 targets, one class."""
    gen = torch.Generator().manual_seed(seed)
    b, n, t = 2 * TRAIN_B, 400, 300
    logits = torch.randn(b, n, 2, generator=gen) * 2
    boxes = torch.stack([torch.rand(b, n, generator=gen) * 0.6 + 0.2, torch.rand(b, n, generator=gen) * 0.6 + 0.2,
                         torch.rand(b, n, generator=gen) * 0.35 + 0.05, torch.rand(b, n, generator=gen) * 0.35 + 0.05], -1)
    xy = torch.rand(b, t, 2, generator=gen) * 0.7
    wh = torch.rand(b, t, 2, generator=gen) * 0.28 + 0.02
    tgt = torch.cat([xy, xy + wh], -1)
    labels = torch.zeros(b, t, dtype=torch.int32)
    lo, hi = (150, 301) if dense else (1, 9)
    n_valid = torch.randint(lo, hi, (b,), generator=gen)
    valid = torch.arange(t)[None, :] < n_valid[:, None]
    real = torch.full((b,), n)
    real[:TRAIN_B] = 300
    if dense:
        real[TRAIN_B:TRAIN_B + 4] = 320  # problems with fewer real rows
    row_valid = torch.arange(n)[None, :] < real[:, None]
    return [x.to("cuda") for x in (logits, boxes, tgt, labels, valid, row_valid)]


def auction_check(cost, valid, row_valid, rows_k, rows_p, rounds, eps_frac=0.001, max_iters=256):
    """Duplicate-free rows, and per problem: equal rows, or totals within
    T*eps of each other; and, where the auction converged (fewer than
    max_iters rounds: the eps-optimality bound holds only then), within
    T*eps of scipy's optimum. ``cost`` is the (B, T, N) negated value matrix
    the solver saw. Returns (differing targets, largest |total_k - total_p|,
    [(problem, total - optimum) of the capped ones])."""
    from scipy.optimize import linear_sum_assignment

    cost, rk, rp = (x.cpu().numpy() for x in (cost, rows_k, rows_p))
    valid, row_valid = valid.cpu().numpy(), row_valid.cpu().numpy()
    differ, worst, capped = 0, 0.0, []
    for i in range(cost.shape[0]):
        if len(set(rk[i].tolist())) != rk.shape[1]:
            raise AssertionError(f"kernel rows of problem {i} are not duplicate-free")
        v = valid[i]
        cols = v.nonzero()[0]
        c = cost[i][:, row_valid[i]]
        vrange = max(c[v].max() - min(c[v].min(), 0.0 if (~v).any() else c[v].min()), 1e-6)
        bound = v.sum() * eps_frac * vrange + 1e-3
        tk, tp = cost[i][cols, rk[i][v]].sum(), cost[i][cols, rp[i][v]].sum()
        r, col = linear_sum_assignment(c[v])
        best = c[v][r, col].sum()
        if not row_valid[i][rk[i][v]].all():
            raise AssertionError(f"problem {i}: a valid target took a padded row")
        if int(rounds[i]) >= max_iters:
            capped.append((i, round(float(tk - best), 4)))
        elif tk > best + bound:
            raise AssertionError(f"problem {i}: kernel total {tk:.5f} vs optimum {best:.5f} (bound {bound:.5f})")
        if not (rk[i] == rp[i]).all():
            differ += int((rk[i] != rp[i]).sum())
            worst = max(worst, abs(tk - tp))
            if abs(tk - tp) > bound:
                raise AssertionError(f"problem {i}: rows differ beyond a near-tie ({tk:.5f} vs {tp:.5f})")
    return differ, worst, capped


def auction_bound(inputs, valid, row_valid, bids, rate, pair_ops=AUCTION_PAIR_OPS):
    """Least time of an auction kernel's function on these inputs, (ms,
    "bytes" or "operations"). Bytes: each input tensor read once and the rows
    written once, over the HBM rate, plus the real rows of each column's value
    row read once per bid it made, over the L2 rate. Operations: ``pair_ops``
    for every (valid column, real row) entry (#9: the cost and the range; #8:
    the range), plus three per real row scanned by a bid, over the float32
    peak. Invalid columns need neither: they hold 0 on every real row, so
    their completion needs only row_valid."""
    b, t = valid.shape
    real = row_valid.sum(1).cpu().long()
    io = sum(x.numel() * x.element_size() for x in inputs) + b * t * 4
    bid_rows = int((bids * real).sum())
    t_bytes = io / HBM_RATE + bid_rows * 4 / rate
    ops = int((valid.sum(1).cpu().long() * real).sum()) * pair_ops + 3 * bid_rows
    t_ops = ops / F32_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_auction(torch, seed):
    from object_detection_destr_tpu_torch.ops.cuda.auction import (
        fused_auction,
        fused_auction_operands,
        fused_cost_inputs,
        hungarian_match_fused_reference,
        matching_value_reference,
    )

    rate = l2_rate(torch)
    log(f"auction: L2 read rate {rate / 1e12:.2f} TB/s (1 GiB read in one launch from 64 rows of 16 MB "
        f"shifted by 128 KB, 24 MB in all, on this card; at least the HBM rate)")
    rows = []
    for dense in (False, True):
        args = auction_problems(torch, seed, dense)
        rows_k, rounds_k = fused_auction(*args)
        torch.cuda.synchronize()
        bids = fused_auction.last_bids.cpu().long()
        plain_bids = torch.zeros(args[0].shape[0], dtype=torch.long, device="cuda")
        rows_p, rounds_p = hungarian_match_fused_reference(*args, bids_out=plain_bids)
        logits, boxes, tgt, labels, valid, row_valid = args
        pn, atan_p, atan_g = fused_cost_inputs(logits, boxes, tgt)
        cost = -matching_value_reference(pn, boxes, atan_p, tgt, atan_g, labels, valid, row_valid)
        differ, worst, capped = auction_check(cost, valid, row_valid, rows_k, rows_p, rounds_k.cpu())
        ms = time_cuda(torch, lambda: fused_auction(*args))
        device = device_ms(torch, lambda: fused_auction(*args))
        operands = fused_auction_operands(*args)
        fused_auction.launch(operands)
        kernel_ms = device_ms(torch, lambda: fused_auction.launch(operands))
        plain_ms = time_cuda(torch, lambda: hungarian_match_fused_reference(*args), reps=3)
        n_valid = valid.sum(1).cpu()
        rounds = rounds_k.cpu().long()
        if not ((bids >= rounds) & (bids <= rounds * n_valid)).all():
            raise AssertionError(f"bid counts {bids.tolist()} do not fit rounds {rounds.tolist()}")
        same_counts = rounds.tolist() == rounds_p.cpu().tolist() and bids.tolist() == plain_bids.cpu().tolist()
        if not dense and not (same_counts and differ == 0):
            raise AssertionError(f"synthetic #9: {differ} rows differ from plain, rounds {rounds.tolist()} vs "
                                 f"{rounds_p.cpu().tolist()}, bids {bids.tolist()} vs {plain_bids.cpu().tolist()}")
        bound, bound_by = auction_bound(args, valid, row_valid, bids, rate)
        setting = "dense" if dense else "synthetic"
        row = dict(setting=setting, differ=differ, max_abs_err=worst, ms=ms, device_ms=device,
                   kernel_device_ms=kernel_ms, capped=capped, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   rounds=rounds.tolist(), plain_rounds=rounds_p.cpu().tolist(), bids=int(bids.sum()),
                   plain_bids=int(plain_bids.sum()), same_counts=same_counts)
        rows.append(row)
        log(f"auction {setting:9s}: 32 problems N=400 T=300, valid targets {n_valid.min().item()}-"
            f"{n_valid.max().item()}; rows differing from plain {differ} (largest total gap {worst:.2e}); "
            f"rounds kernel {row['rounds']} plain {row['plain_rounds']}; bids kernel {row['bids']} plain "
            f"{row['plain_bids']}; ms={ms:.4f} (eager call, prologue included) device_ms={device:.4f} (the call, "
            f"CUDA graph) kernel_device_ms={kernel_ms:.4f} (the launch alone, CUDA graph) plain_ms={plain_ms:.2f} "
            f"bound_ms={bound:.6f} ({bound_by}); recorded eager ms before this solver "
            f"{AUCTION_RECORDED_MS['fused_auction'][setting]} (not this run); converged problems within T*eps of "
            f"scipy's optimum; {len(capped)} stopped at the 256-round cap, total above the optimum by {capped} OK")
    # the greedy completion with valid columns left (the rounds capped), and
    # problems with fewer real rows than columns (invalid columns run out of
    # free real rows and take row 0): rows, rounds and bids equal to plain
    args = auction_problems(torch, seed + 3, False)
    exhausted = list(args)
    exhausted[5] = exhausted[5].clone()
    exhausted[5][::4, 250:] = False  # 250 real rows for 300 columns
    for label, problem, max_iters in (("capped 1", args, 1), ("capped 2", args, 2), ("capped 4", args, 4),
                                      ("250 real rows", exhausted, 256)):
        rows_k, rounds_k = fused_auction(*problem, max_iters=max_iters)
        torch.cuda.synchronize()
        bids = fused_auction.last_bids.cpu().long()
        plain_bids = torch.zeros(problem[0].shape[0], dtype=torch.long, device="cuda")
        rows_p, rounds_p = hungarian_match_fused_reference(*problem, max_iters=max_iters, bids_out=plain_bids)
        differ = int((rows_k != rows_p).sum())
        if differ or rounds_k.cpu().long().tolist() != rounds_p.cpu().tolist() \
                or bids.tolist() != plain_bids.cpu().tolist():
            raise AssertionError(f"#9 {label}: {differ} rows differ from plain, rounds {rounds_k.tolist()} vs "
                                 f"{rounds_p.tolist()}, bids {bids.tolist()} vs {plain_bids.tolist()}")
        log(f"auction {label}: rows, rounds and bids equal to plain (rounds {rounds_k.cpu().tolist()}) OK")
    return rows, rate


def phase_assignment(torch, kernels, seed, rate):
    """Kernel #8 through its entry points on the card:
    hungarian_match(cost_bbox=2.5) on 16 problems of the model's 300
    queries, then of the mini-detector's 400 tokens, T=300, with at most 8
    and with 150-300 valid targets; then set_criterion(rows=None,
    cost_bbox=2.5). One #8 launch (and no other kernel) a call; rows held
    against the plain solver on the same value matrix as in phase 4."""
    from object_detection_destr_tpu_torch.losses.criterion import set_criterion
    from object_detection_destr_tpu_torch.losses.matcher import hungarian_cost_matrix, hungarian_match
    from object_detection_destr_tpu_torch.ops.assignment import batched_assignment
    from object_detection_destr_tpu_torch.ops.cuda.auction import auction_kernel, precomputed_value, solve_auction

    problems = []
    for dense in (False, True):
        logits, boxes, tgt, labels, valid, _ = auction_problems(torch, seed + 1, dense)
        for n, part in ((300, slice(0, TRAIN_B)), (400, slice(TRAIN_B, 2 * TRAIN_B))):
            outputs = {"pred_class": logits[part, :n], "pred_boxes": boxes[part, :n]}
            targets = {"boxes": tgt[part], "labels": labels[part], "valid": valid[part]}
            problems.append((("dense" if dense else "synthetic"), n, outputs, targets))

    reset_counts(kernels)  # the L1-cost matcher's path starts here
    results = []
    for setting, n, outputs, targets in problems:
        before = [k.launches for k in kernels]
        rows_k = hungarian_match(outputs, targets, cost_bbox=2.5)
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        results.append((rows_k, auction_kernel.last_rounds.cpu().long(), auction_kernel.last_bids.cpu().long(),
                         launched))
    losses = set_criterion(problems[0][2], problems[0][3], cost_bbox=2.5, class_norm="boxes")
    torch.cuda.synchronize()
    counts = [k.launches for k in kernels]  # read just after the path
    want = [0, 0, 0, 0, 0, len(problems) + 1, 0, 0, 0]
    if counts != want or any(r[3] != want[:5] + [1, 0, 0, 0] for r in results):
        raise AssertionError(f"#8's entry points launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}")
    if not all(math.isfinite(v.item()) for v in losses.values()):
        raise AssertionError(f"non-finite criterion through #8: {losses}")

    rows = []
    for (setting, n, outputs, targets), (rows_k, rounds, bids, _) in zip(problems, results):
        valid = targets["valid"]
        cost = hungarian_cost_matrix(outputs, targets, 1.0, 2.5, 1.0)
        value = precomputed_value(cost, valid)
        row_valid = torch.ones(cost.shape[:2], dtype=torch.bool, device="cuda")
        plain_bids = torch.zeros(value.shape[0], dtype=torch.long, device="cuda")
        rows_p, rounds_p = solve_auction(value, valid, row_valid, bids_out=plain_bids)
        differ, worst, capped = auction_check(-value, valid, row_valid, rows_k, rows_p, rounds)
        n_valid = valid.sum(1).cpu()
        if not ((bids >= rounds) & (bids <= rounds * n_valid)).all():
            raise AssertionError(f"bid counts {bids.tolist()} do not fit rounds {rounds.tolist()}")
        same_counts = rounds.tolist() == rounds_p.cpu().tolist() and bids.tolist() == plain_bids.cpu().tolist()
        if setting == "synthetic" and not (same_counts and differ == 0):
            raise AssertionError(f"synthetic #8: {differ} rows differ from plain, rounds {rounds.tolist()} vs "
                                 f"{rounds_p.cpu().tolist()}, bids {bids.tolist()} vs {plain_bids.cpu().tolist()}")
        ms = time_cuda(torch, lambda: batched_assignment(cost, valid))
        kernel_ms = device_ms(torch, lambda: auction_kernel(value, valid, row_valid))
        plain_ms = time_cuda(torch, lambda: solve_auction(precomputed_value(cost, valid), valid, row_valid), reps=3)
        bound, bound_by = auction_bound((cost, valid), valid, row_valid, bids, rate, pair_ops=2)
        row = dict(setting=setting, n=n, differ=differ, max_abs_err=worst, ms=ms, kernel_device_ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, rounds=rounds.tolist(),
                   plain_rounds=rounds_p.cpu().tolist(), bids=int(bids.sum()), plain_bids=int(plain_bids.sum()),
                   same_counts=same_counts, capped=capped)
        rows.append(row)
        recorded = AUCTION_RECORDED_MS["auction_assignment"].get(setting) if n == 300 else None
        log(f"assignment {setting:9s}: hungarian_match(cost_bbox=2.5), 16 problems N={n} T=300, valid targets "
            f"{n_valid.min().item()}-{n_valid.max().item()}; one #8 launch; rows differing from plain {differ} "
            f"(largest total gap {worst:.2e}); rounds kernel {row['rounds']} plain {row['plain_rounds']}; bids "
            f"kernel {row['bids']} plain {row['plain_bids']}; ms={ms:.4f} (batched_assignment: value matrix + "
            f"kernel) kernel_device_ms={kernel_ms:.4f} (the launch alone, CUDA graph) plain_ms={plain_ms:.2f} "
            f"bound_ms={bound:.6f} ({bound_by})"
            + (f"; recorded ms before this solver {recorded} (not this run)" if recorded else "")
            + f"; {len(capped)} stopped at the 256-round cap, total above the optimum by {capped} OK")
    log(f"assignment: set_criterion(rows=None, cost_bbox=2.5) launched #8 once; losses "
        + " ".join(f"{k}={v.item():.4f}" for k, v in losses.items()))
    return rows, counts


def recipe_train_config(extra=()):
    """The TrainConfig that the trainer builds from TRAIN_ARGS (+ ``extra``)."""
    return recipe_config(extra).train


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def phase_train(torch, kernels, seed, extra=(), per_step=(18, 18, 0, 0, 1, 0, 0, 0, 0), label="hidden 256"):
    """The production recipe (+ ``extra`` flags) through the trainer's entry
    point, with an empty validation split (phase 8 validates); ``per_step``
    the launches of each kernel a step."""
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train import train as train_cli
    from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser

    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build",
                           "chip_smoke_train_" + label.replace(" ", "_"))
    with tempfile.TemporaryDirectory() as checkpoints:
        argv = TRAIN_ARGS + list(extra) + ["--seed", str(seed), "--log_dir", log_dir, "--num_valid_samples", "0",
                                           "--checkpoint_dir", checkpoints]
        reset_counts(kernels)  # the main path starts here
        t0 = time.perf_counter()
        result = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]  # read just after the main path
    state = result["state"]
    steps = state.step
    want = [n * steps for n in per_step]
    if steps != TRAIN_STEPS or counts != want:
        raise AssertionError(f"{steps} steps launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}")
    metrics = result["metrics"]
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite or missing losses: {metrics}")
    if state.optimizer.count != steps:
        raise AssertionError(f"{state.optimizer.count} of {steps} updates applied")
    config = config_from_args(get_parser("destr").parse_args(argv), "destr")
    torch.manual_seed(seed)
    initial = build_destr(config.destr, "cuda")
    model = state.model
    moved = {n: not torch.equal(getattr_path(model, n), getattr_path(initial, n))
             for n in ("cls_embed.weight", "decoder.block0.sa_q_obj.weight",
                       "backbone.layer2_0.conv1.weight", "backbone.conv1.weight", "backbone.bn1.running_var")}
    if moved != {"cls_embed.weight": True, "decoder.block0.sa_q_obj.weight": True,
                 "backbone.layer2_0.conv1.weight": True, "backbone.conv1.weight": False,
                 "backbone.bn1.running_var": False}:
        raise AssertionError(f"parameter updates not as the groups say: {moved}")
    del initial
    step_ms = result["step_ms"]
    median = statistics.median(step_ms[1:])
    log(f"train {label}: {steps} steps of the production recipe (B={TRAIN_B}, 640px, bf16, 6+6 blocks, top_k 300, "
        f"dropout {RATE}, hidden {config.destr.hidden_dim}) in {wall:.1f} s (with a _last checkpoint); launches "
        f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} "
        f"({'/'.join(str(c // steps) for c in counts)} a step); last losses "
        + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    log(f"train {label}: the matcher's bidding rounds in the last step (16 model problems, then 16 "
        f"mini-detector problems): {kernels[4].last_rounds.tolist()}")
    log(f"train {label}: step ms (CUDA events) {', '.join(f'{t:.1f}' for t in step_ms)}; median after the first "
        f"{median:.2f} ms = {TRAIN_B / median * 1e3:.1f} images/s; driver's epoch images/s "
        f"{result['images_per_sec']:.1f}; parameters moved {moved}")
    return state, counts, median


def getattr_path(module, name):
    for part in name.split("."):
        module = getattr(module, part)
    return module


def step_parts(torch, state, batch, cfg, reps=3):
    """Median milliseconds of the parts of the trainer's own step
    (``make_destr_train_step``) over ``reps`` steps, on the device timeline
    with host launch gaps inside: CUDA events recorded around the model call,
    the matcher, the two criteria, the BatchNorm-statistics guard and the
    optimizer update; "backward" runs from the second criterion's end to the
    guard (the loss sum and loss.backward())."""
    from object_detection_destr_tpu_torch.train import steps

    marks = {}

    def mark(key, first=False):
        if first and key in marks:
            return
        marks[key] = torch.cuda.Event(enable_timing=True)
        marks[key].record()

    def around(name, fn):
        def inner(*args, **kwargs):
            mark(name + ">", first=True)
            out = fn(*args, **kwargs)
            mark(name + "<")
            return out
        return inner

    originals = (steps._match_pair, steps.set_criterion, steps._guard_stats)
    steps._match_pair = around("matcher", originals[0])
    steps.set_criterion = around("criterion", originals[1])
    steps._guard_stats = around("guard", originals[2])
    state.optimizer.step = around("optimizer", state.optimizer.step)
    hooks = [state.model.register_forward_pre_hook(lambda *_: mark("forward>")),
             state.model.register_forward_hook(lambda *_: mark("forward<"))]
    spans = {"forward": ("forward>", "forward<"), "matcher": ("matcher>", "matcher<"),
             "criterion": ("criterion>", "criterion<"), "backward": ("criterion<", "guard>"),
             "stats guard": ("guard>", "guard<"), "optimizer": ("optimizer>", "optimizer<"),
             "step": ("step>", "step<")}
    parts = {k: [] for k in spans}
    train_step = steps.make_destr_train_step(cfg)
    try:
        for _ in range(reps):
            marks.clear()
            mark("step>")
            train_step(state, batch)
            mark("step<")
            torch.cuda.synchronize()
            for k, (a, b) in spans.items():
                parts[k].append(marks[a].elapsed_time(marks[b]))
    finally:
        steps._match_pair, steps.set_criterion, steps._guard_stats = originals
        del state.optimizer.step
        for hook in hooks:
            hook.remove()
    return {k: statistics.median(v) for k, v in parts.items()}


def train_batch(torch, b, seed, out_size=640):
    from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset
    from object_detection_destr_tpu_torch.data.transforms import destr_train_transform

    canvas = out_size * 672 // 640
    loader = DetectionLoader(build_dataset("synthetic", image_size=canvas, num_samples=b, seed=seed),
                             batch_size=b, canvas_size=canvas, max_targets=300, prefetch=0)
    raw = next(iter(loader))
    to = lambda a: torch.from_numpy(a).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    return destr_train_transform(to(raw["images"]), to(raw["boxes"]), to(raw["labels"]), to(raw["valid"]),
                                 gen, out_size=out_size)


@contextlib.contextmanager
def choices(record=None, replay=None):
    """Record (or replay) the train step's discrete choices: the pairs of
    every decoder block, the mini-detector's top-k, the matcher's rows."""
    from object_detection_destr_tpu_torch.models.destr import mini_detector, pair_attention
    from object_detection_destr_tpu_torch.train import steps

    originals = (pair_attention.get_pairs, mini_detector.masked_topk_with_recycle, steps.hungarian_match_fused)
    replayed = iter(replay) if replay is not None else None

    def wrap(kind, fn):
        def inner(*args, **kwargs):
            out = next(replayed)[2] if replayed is not None else fn(*args, **kwargs)
            if record is not None:
                record.append((kind, [a.detach().clone() if hasattr(a, "detach") else a for a in args]
                               + [kwargs.get("row_valid")], out.clone()))
            return out
        return inner

    pair_attention.get_pairs = wrap("pairs", originals[0])
    mini_detector.masked_topk_with_recycle = wrap("topk", originals[1])
    steps.hungarian_match_fused = wrap("rows", originals[2])
    try:
        yield
    finally:
        pair_attention.get_pairs, mini_detector.masked_topk_with_recycle, steps.hungarian_match_fused = originals


@contextlib.contextmanager
def plain_kernels():
    """Route the kernels' wrappers to their plain versions for one run."""
    from object_detection_destr_tpu_torch.ops import assignment
    from object_detection_destr_tpu_torch.ops.cuda import auction, flash_attention as fa

    swaps = [(fa, "flash_attention_fwd", fa.flash_attention_packed_reference),
             (fa, "flash_attention_bwd", fa.flash_attention_packed_backward_reference),
             (fa, "flash_attention_dq", fa.flash_attention_dq_reference),
             (fa, "flash_attention_dkv", fa.flash_attention_dkv_reference),
             (auction, "fused_auction", auction.hungarian_match_fused_reference),
             (assignment, "auction_kernel", auction.solve_auction)]
    originals = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), original in zip(swaps, originals):
            setattr(module, name, original)


def choice_margin(torch, kind, recorded, other):
    """The margin of a differing discrete choice, on the kernel run's inputs:
    the IoU / size gap of a pair, the score gap of a top-k pick, the total
    cost gap (over T * eps) of the matcher's rows."""
    from object_detection_destr_tpu_torch.ops.cuda.auction import fused_cost_inputs, matching_value_reference

    args, mine = recorded
    if kind == "pairs":
        return pair_flip_margins(torch, args[0], mine, other)[1]
    if kind == "topk":
        scores = args[0]
        return (scores.gather(1, mine) - scores.gather(1, other)).abs().max().item()
    logits, boxes, tgt, labels, valid, row_valid = args[:5] + [args[-1]]
    pn, atan_p, atan_g = fused_cost_inputs(logits, boxes, tgt)
    value = matching_value_reference(pn, boxes, atan_p, tgt, atan_g, labels, valid, row_valid)
    worst = 0.0
    for i in range(value.shape[0]):
        v = valid[i]
        gap = (value[i][v].gather(1, mine[i][v][:, None]).sum() - value[i][v].gather(1, other[i][v][:, None]).sum()).abs()
        real = value[i][v][:, row_valid[i]]
        eps = 0.001 * max((real.max() - min(real.min(), 0.0)).item(), 1e-6)
        worst = max(worst, gap.item() / max(v.sum().item() * eps, 1e-12))
    return worst


def first_flip(torch, mine, theirs):
    """[(kind, margin)] of the choices where two recorded runs differ, in
    order; margins on the first run's inputs (choice_margin)."""
    return [(kind, choice_margin(torch, kind, (args, a), b))
            for (kind, args, a), (_, _, b) in zip(mine, theirs) if not torch.equal(a, b)]


def phase_train_compare(torch, kernels, seed, destr=None, image_size=640):
    """One whole train step at B=4, float32, dropout 0: kernels against
    plain versions, from the same weights and batch (full width unless
    ``destr`` gives DestrConfig fields). Returns the kernel step's launches
    of each kernel."""
    from object_detection_destr_tpu_torch.config import DestrConfig
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.state import create_destr_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_train_step

    cfg = dataclasses.replace(recipe_train_config(), batch_size=4)
    label = f"hidden {(destr or {}).get('hidden_dim', 256)}"
    torch.manual_seed(seed)
    model = build_destr(DestrConfig(**dict(destr or {}, dropout=0.0)), "cuda")
    randomize_(torch, model, seed)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(torch, 4, seed, image_size)
    step = make_destr_train_step(cfg)

    def run(plain, record=None, replay=None):
        model.load_state_dict(initial)
        state = create_destr_state(model, cfg, steps_per_epoch=10)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            stack.enter_context(choices(record, replay))
            metrics = step(state, batch)
        torch.cuda.synchronize()
        return ({k: v.item() for k, v in metrics.items()}, {k: v.clone() for k, v in state.optimizer.m.items()},
                {k: v.clone() for k, v in model.state_dict().items()})

    kernel_choices, plain_choices = [], []
    reset_counts(kernels)
    kernel = run(False, record=kernel_choices)
    launches = [k.launches for k in kernels]
    plain = run(True, record=plain_choices)
    if [k.launches for k in kernels] != launches:
        raise AssertionError("the plain step launched a kernel")
    flips = first_flip(torch, kernel_choices, plain_choices)
    if flips:
        log(f"train compare {label}: the plain run chose otherwise at {len(flips)} discrete choices: "
            + ", ".join(f"{k} (margin {m:.2e})" for k, m in flips))
        kind, margin = flips[0]  # later flips may follow from the first
        if margin >= (1.0 if kind == "rows" else 1e-4):
            raise AssertionError(f"a discrete choice differs where it is no near-tie: {flips}")
        plain = run(True, replay=kernel_choices)
        log(f"train compare {label}: plain step repeated on the kernel run's choices")

    errs = {}
    for k, v in kernel[0].items():
        errs[f"metric {k}"] = (abs(v - plain[0][k]) / max(abs(plain[0][k]), 1e-3), 1e-4)
    # leaves whose gradient is zero in exact arithmetic (conv biases before
    # BatchNorm, key biases) hold float32 noise: scale floored at 1e-3 of
    # the largest moment
    floor = 1e-3 * max(t.abs().max().item() for t in plain[1].values())
    worst_m = {"backbone": 0.0, "rest": 0.0}
    for name, m in kernel[1].items():
        ref = plain[1][name]
        e = (m - ref).abs().max().item() / max(ref.abs().max().item(), floor)
        part = "backbone" if name.startswith("backbone.") else "rest"
        worst_m[part] = max(worst_m[part], e)
    # read on the card in four runs: backbone 1.48e-4, the rest 3.04e-3
    errs["grad backbone"] = (worst_m["backbone"], 1e-2)
    errs["grad rest"] = (worst_m["rest"], 5e-3)
    # Adam's first update is +-lr_0 an element whatever the gradient, so the
    # parameters only show that no update went astray; the gradients (first
    # moments) above carry the comparison. Reported: the share of moved
    # elements whose update direction differs.
    param_gap, stat_gap, flipped, moved = 0.0, 0.0, 0, 0
    for name, p in kernel[2].items():
        gap = (p.float() - plain[2][name].float()).abs().max().item()
        if name.endswith(("running_mean", "running_var")) and "mini_detector" in name:
            stat_gap = max(stat_gap, gap / max(plain[2][name].abs().max().item(), 1e-6))
        elif p.is_floating_point():
            param_gap = max(param_gap, gap)
            dk, dp = (p - initial[name]).sign(), (plain[2][name] - initial[name]).sign()
            flipped += int(((dk != dp) & (dp != 0)).sum())
            moved += int((dp != 0).sum())
    errs["params (abs, <= 2 lr)"] = (param_gap, 2 * cfg.lr + 1e-6)
    errs["bn stats"] = (stat_gap, 1e-4)
    log(f"train compare {label} B=4 f32, kernel vs plain: " + " ".join(f"{k}={v:.2e} (tol {t:.0e})" for k, (v, t) in errs.items())
        + f"; update direction differs in {flipped} of {moved} moved elements; kernel step launched "
        f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {launches}")
    bad = [k for k, (v, t) in errs.items() if not v <= t]
    if bad:
        raise AssertionError(f"kernel and plain train steps differ: {bad}")
    return launches


VALID_SAMPLES = 32  # two validation batches
EAGER_RUNS = 5  # eager samples a captured one is held against (their pairwise distances give the spread)


def phase_validation(torch, kernels, seed, ckpt):
    """The validation path through the trainer's and the evaluator's entry
    points: the production recipe with a 32-image validation split, the
    parameter EMA, COCO AP and checkpoints in ``ckpt`` (kept for phase 17),
    for one epoch of 4 steps; then ``infer.evaluate.main`` on the best
    checkpoint; then a resume from ``_last`` for one more epoch. Returns the
    launches of the training run and what was timed."""
    from object_detection_destr_tpu_torch.infer import evaluate
    from object_detection_destr_tpu_torch.losses.metrics import CocoAveragePrecision, MeanAveragePrecision
    from object_detection_destr_tpu_torch.train import train as train_cli
    from object_detection_destr_tpu_torch.train.checkpoint import save_checkpoint
    from object_detection_destr_tpu_torch.train.driver import _eval_batch, _make_ema, _make_loaders
    from object_detection_destr_tpu_torch.train.steps import make_destr_eval_step

    base = TRAIN_ARGS + ["--seed", str(seed), "--num_valid_samples", str(VALID_SAMPLES), "--checkpoint_dir", ckpt,
                         "--log_dir", os.path.join(ckpt, "runs")]
    argv = base + ["--ema_decay", "0.999", "--coco_eval", "--save_as", "smoke"]
    reset_counts(kernels)  # the validation path starts here
    t0 = time.perf_counter()
    result = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]  # read just after the path
    state, history = result["state"], result["history"]
    batches = 2 * (VALID_SAMPLES // TRAIN_B)  # the live and the EMA sweep
    want = [18 * TRAIN_STEPS + 18 * batches, 18 * TRAIN_STEPS, 0, 0, TRAIN_STEPS + batches, 0, 0, 0, 0]
    if state.step != TRAIN_STEPS or counts != want:
        raise AssertionError(f"{state.step} steps and {batches} validation batches launched "
                             f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}")
    files = sorted(f for f in os.listdir(ckpt) if f.startswith("smoke"))
    if files != ["smoke", "smoke_ema", "smoke_last"]:
        raise AssertionError(f"checkpoints {files}, not smoke, smoke_ema and smoke_last")
    record = history[0]
    scalars = [record["mAP"], record["coco_mAP"], record["ema_mAP"], record["ema_coco_mAP"],
               *record["valid"].values(), *record["valid_ema"].values()]
    if not all(math.isfinite(v) for v in scalars):
        raise AssertionError(f"non-finite validation scalars: {record}")

    # the evaluator on the best checkpoint, before anything can overwrite it
    before = kernels[0].launches
    evaluated = evaluate.main(base + ["--resume_from", "smoke"])
    eval_launches = kernels[0].launches - before
    if abs(evaluated["map"] - record["mAP"]) > 1e-6 or evaluated["n_images"] != VALID_SAMPLES:
        raise AssertionError(f"evaluate: map {evaluated['map']} over {evaluated['n_images']} images, the "
                             f"driver's epoch-0 mAP {record['mAP']}")

    # where a validation batch goes (the host loader, the transform, the
    # eval step, the metrics), the EMA update and a checkpoint
    config = recipe_config(["--num_valid_samples", str(VALID_SAMPLES)])
    _, valid_loader = _make_loaders(config, 672, "destr")
    t0 = time.perf_counter()
    raws = list(valid_loader)  # the letterboxed host batches of one sweep
    loader_s = time.perf_counter() - t0
    transform_ms = time_cuda(torch, lambda: _eval_batch(raws[0], torch.device("cuda"), 672, 640))
    batch = _eval_batch(raws[0], torch.device("cuda"), 672, 640)
    eval_step = make_destr_eval_step(config.train)
    val_batch_ms = time_cuda(torch, lambda: eval_step(state, batch))
    outputs, _ = eval_step(state, batch)
    targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
    metric, coco = MeanAveragePrecision(1, num_pred=300), CocoAveragePrecision(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metric.update(metric.init_state(), outputs, targets)
    map_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    coco.update(outputs, targets)
    coco_ms = (time.perf_counter() - t0) * 1e3
    init, update = _make_ema(0.999)
    ema = init(state.model)
    ema_ms = time_cuda(torch, lambda: update(ema, state.model))
    del ema
    t0 = time.perf_counter()
    path = save_checkpoint(ckpt, "timed", state, {"epoch": 1, "step": 0}, 1.0)
    save_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6
    n_params = sum(p.numel() for p in state.model.parameters())
    del state, result
    torch.cuda.empty_cache()

    # resume from _last: the step counter and the loader go on
    resumed = train_cli.main(base + ["--save_as", "smoke", "--resume", "--resume_from", "smoke_last",
                                     "--epochs", "1"])
    torch.cuda.synchronize()
    if resumed["state"].step != 2 * TRAIN_STEPS or resumed["history"][-1]["step"] != 2 * TRAIN_STEPS:
        raise AssertionError(f"the resumed run ended at step {resumed['state'].step}, not {2 * TRAIN_STEPS}")
    del resumed
    sweep_s = record["seconds"]
    timing = {"val_batch_ms": val_batch_ms, "val_images_per_sec": VALID_SAMPLES / sweep_s[0],
              "sweep_seconds": sweep_s, "ema_update_ms": ema_ms, "checkpoint_mb": size_mb,
              "checkpoint_save_s": save_s, "eval_launches": eval_launches, "loader_s": loader_s,
              "transform_ms": transform_ms, "map_update_ms": map_ms, "coco_update_ms": coco_ms}
    log(f"validation: {TRAIN_STEPS} steps and {VALID_SAMPLES} validation images (live and EMA sweeps) through "
        f"train.main in {wall:.1f} s; launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}; checkpoints {files}; epoch 0 "
        f"mAP={record['mAP']:.6f} coco_mAP={record['coco_mAP']:.6f} ema_mAP={record['ema_mAP']:.6f} "
        f"ema_coco_mAP={record['ema_coco_mAP']:.6f} valid {record['valid']} valid_ema {record['valid_ema']}")
    log(f"validation: infer.evaluate on smoke: map={evaluated['map']:.6f} (driver {record['mAP']:.6f}) "
        f"coco_map={evaluated['coco_map']:.6f}, #1 launched {eval_launches} times; resume from smoke_last went on "
        f"from step {TRAIN_STEPS} to {2 * TRAIN_STEPS} OK")
    log(f"validation: eval step ms a batch of {TRAIN_B}={val_batch_ms:.2f} (CUDA events, eager); sweep seconds "
        f"{', '.join(f'{t:.2f}' for t in sweep_s)} (host clock, loader + transform + step + metrics) = "
        f"{timing['val_images_per_sec']:.1f} images/s; by part: the host loader {loader_s:.2f} s for "
        f"{VALID_SAMPLES} letterboxed images (host clock), the eval transform {transform_ms:.2f} ms a batch "
        f"(copy and resample, CUDA events), the mAP update {map_ms:.2f} ms and the COCO update {coco_ms:.2f} ms a "
        f"batch (host clock, device work and the copies to the host inside); EMA update ms={ema_ms:.3f} "
        f"({n_params / 1e6:.1f} M parameters); checkpoint "
        f"{size_mb:.1f} MB written in {save_s:.2f} s")
    return counts, timing


def recipe_config(extra=()):
    """The Config that the trainer builds from TRAIN_ARGS (+ ``extra``)."""
    from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser

    return config_from_args(get_parser("destr").parse_args(TRAIN_ARGS + list(extra)), "destr")


def randomize_(torch, model, seed):
    """Random weights from a torch.Generator: weights ~ 1/sqrt(fan_in), norm
    scales near 1, BatchNorm and frozen-BN statistics away from identity."""
    from torch import nn

    from object_detection_destr_tpu_torch.models.resnet import FrozenBatchNorm

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(t, std=1.0, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * std + mean)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                randn(module.weight, (module.weight[0].numel()) ** -0.5)
                if module.bias is not None:
                    randn(module.bias, 0.02)
            elif isinstance(module, nn.LayerNorm):
                randn(module.weight, 0.1, 1.0)
                randn(module.bias, 0.05)
            elif isinstance(module, nn.Embedding):
                randn(module.weight)
            elif isinstance(module, (nn.BatchNorm2d, FrozenBatchNorm)):
                randn(module.weight, 0.1, 1.0)
                randn(module.bias, 0.1)
                randn(module.running_mean, 0.1)
                module.running_var.copy_(
                    torch.rand(module.running_var.shape, generator=gen, device="cuda") + 0.5
                )


def forward_parts(torch, model, images, reps=6):
    """Median milliseconds of one eager forward and of each of its top-level
    parts, on the device's timeline (host launch gaps included), from CUDA
    events recorded by forward hooks; the first pass is dropped."""
    names = ("forward", "backbone", "encoder", "mini_detector", "decoder")
    spans = {name: [] for name in names}
    handles = []
    for name in names:
        def before(module, args, name=name):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            spans[name].append([start, None])

        def after(module, args, output, name=name):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans[name][-1][1] = end

        module = model if name == "forward" else getattr(model, name)
        handles += [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    try:
        with torch.inference_mode():
            for _ in range(reps):
                model(images)
        torch.cuda.synchronize()
    finally:
        for handle in handles:
            handle.remove()
    return {name: statistics.median(s.elapsed_time(e) for s, e in spans[name][1:]) for name in names}


def phase_serving(torch, kernel, seed, images):
    from object_detection_destr_tpu_torch.config import DestrConfig
    from object_detection_destr_tpu_torch.infer.server import _make_handler, build_service, get_parser
    from object_detection_destr_tpu_torch.models.convert import (
        flax_variables_from_state_dict,
        save_variables_npz,
    )
    from object_detection_destr_tpu_torch.models.destr.model import build_destr

    weights_dir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "object_detection_destr_tpu_torch", "_build"
    )
    os.makedirs(weights_dir, exist_ok=True)
    start = time.perf_counter()
    source = build_destr(DestrConfig(), "cuda")
    randomize_(torch, source, seed)
    variables = flax_variables_from_state_dict(source)
    del source
    save_variables_npz(variables, os.path.join(weights_dir, "chip_smoke_weights.npz"))
    args = get_parser().parse_args(
        ["--checkpoint_dir", weights_dir, "--weights", "chip_smoke_weights.npz",
         "--score_thresh", "0.0"]
    )
    kernel.launches = 0  # the main path starts here: the service's warm-up forward and capture, then requests
    service = build_service(args)  # default: GPU, 640px, letterbox, full width, the predict captured
    built = kernel.launches
    log(f"serving: weights written and service built (warm-up forward and CUDA-graph capture) in "
        f"{time.perf_counter() - start:.1f} s ({sum(p.numel() for p in service.model.parameters()) / 1e6:.1f} M "
        f"parameters); #1's wrapper called {built} times (the warm-up forward's and the capture's)")
    if service.graph is None or built != 2 * 3 * BLOCKS:
        raise AssertionError(f"the service captured no graph, or called #1 {built} times building it")

    def check(dets):
        if len(dets["scores"]) != 300:
            raise AssertionError(f"{len(dets['scores'])} detections at threshold 0, not 300")
        if not all(0.0 <= s <= 1.0 for s in dets["scores"]) or any(
            not (0.0 <= c <= 1.0) for box in dets["boxes"] for c in box
        ):
            raise AssertionError("detections out of range")

    latencies, eager_latencies, counts, served = [], [], [], []
    for rnd in range(2):  # captured requests: graph replays
        for image in images:
            t0 = time.perf_counter()
            dets = service.predict_image(image)
            latencies.append((time.perf_counter() - t0) * 1e3)
            check(dets)
            if rnd == 0:
                counts.append(sum(score >= 0.5 for score in dets["scores"]))
                served.append(dets)
    main_path_launches = kernel.launches  # read just after the main path
    if main_path_launches != built:
        raise AssertionError(f"a replayed request called #1's wrapper ({main_path_launches - built} times)")
    for rnd in range(2):  # the same requests, the model run eagerly
        for image, captured_dets in zip(images, served):
            t0 = time.perf_counter()
            dets = eager_predict_image(torch, service, image)
            eager_latencies.append((time.perf_counter() - t0) * 1e3)
            if dets != captured_dets:
                raise AssertionError("the captured predict's detections differ from the eager forward's")
    windows = {}
    for kind, predict in (("captured", service.predict_image),
                          ("eager", lambda image: eager_predict_image(torch, service, image))):
        def requests(scope, predict=predict):
            for i, image in enumerate(images):
                with scope(i):
                    predict(image)
        windows[kind] = traced(torch, f"serve_{kind}", len(images), requests)
        if windows[kind]["per_step"] != [3.0 * BLOCKS, 0, 0, 0, 0, 0]:
            raise AssertionError(f"a traced {kind} request launched #1/#2/#3/#4/#9/#8 {windows[kind]['per_step']} "
                                 f"(launch lead {windows[kind]['launch_lead_s']} s)")
    log(f"serving: {len(latencies)} captured requests (graph replays, #1's wrapper not called), detections scoring "
        f">= 0.5 {dict(zip(['x'.join(map(str, im.shape[:2])) for im in images], counts))}; the eager forward "
        f"gives the same detections on every request")
    log(f"serving: request latency ms captured median={statistics.median(latencies):.2f} "
        f"min={min(latencies):.2f} max={max(latencies):.2f} (all: {', '.join(f'{t:.2f}' for t in latencies)}); "
        f"eager median={statistics.median(eager_latencies):.2f} max={max(eager_latencies):.2f} (all: "
        f"{', '.join(f'{t:.2f}' for t in eager_latencies)})")
    log("serving: traced requests (4 each): " + "; ".join(
        f"{kind} device busy {w['step_busy_ms']:.3f} ms a request of {w['step_period_ms']:.3f}, idle share "
        f"{w['idle_share']:.4f}, #1 launches a request from the trace {w['per_step'][0]:.0f}"
        for kind, w in windows.items()))
    serve_timing = {"captured_ms": statistics.median(latencies), "captured_max_ms": max(latencies),
                    "eager_ms": statistics.median(eager_latencies), "eager_max_ms": max(eager_latencies),
                    **{f"{kind}_{key}": w[key] for kind, w in windows.items()
                       for key in ("idle_share", "step_busy_ms", "step_period_ms")}}

    # where a request's time goes: host letterbox, then the model on the device
    from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas

    host_ms = []
    for image in images:
        t0 = time.perf_counter()
        _letterbox_canvas(image, 640)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"serving: host letterbox ms per image {', '.join(f'{t:.2f}' for t in host_ms)}")
    # one model forward alone, on the device clock
    canvas = torch.zeros((1, 640, 640, 3), device="cuda")
    parts = forward_parts(torch, service.model, canvas)
    forward_ms = parts.pop("forward")
    log(f"serving: model forward B=1 ms={forward_ms:.2f} (CUDA events); by part ms "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items())
        + f" rest={forward_ms - sum(parts.values()):.2f}")

    # the HTTP front end answers too
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/healthz", timeout=30) as r:
            health = json.load(r)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if health != {"ok": True}:
        raise AssertionError(f"/healthz answered {health}")
    log("serving: HTTP /healthz ok")
    return service, variables, main_path_launches, serve_timing, forward_ms


def eager_predict_image(torch, service, image):
    """``service.predict_image`` with the model run eagerly on the request
    (the host letterbox, the transform, the forward and destr_predict)."""
    import numpy as np

    from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas
    from object_detection_destr_tpu_torch.data.transforms import letterbox_infer_transform
    from object_detection_destr_tpu_torch.infer.predict import destr_predict

    canvas, fh, fw = _letterbox_canvas(image, service.image_size)
    prep = letterbox_infer_transform(torch.from_numpy(canvas[None]).to(service.device),
                                     torch.tensor([[fh, fw]], dtype=torch.float32), out_size=service.image_size)
    with torch.inference_mode():
        outputs, _ = service.model(prep["images"], valid_mask=prep["pixel_valid"])
        dets = {k: v.cpu().numpy() for k, v in destr_predict(outputs, score_thresh=service.score_thresh).items()}
    keep = dets["valid"][0]
    boxes = np.clip(dets["boxes"][0][keep] / np.asarray([fw, fh, fw, fh], np.float32), 0.0, 1.0)
    return {"boxes": boxes.tolist(), "scores": dets["scores"][0][keep].tolist(),
            "labels": dets["labels"][0][keep].tolist()}


def pair_flip_margins(torch, centers, pairs_a, pairs_b):
    """Rows whose pairs differ, and the largest margin of those choices: the
    IoU gap between the two partners, or the size gap where only the left /
    right order differs (the quantities get_pairs takes argmax / >= of)."""
    from object_detection_destr_tpu_torch.geometry.boxes import box_l1_size, cxcyhw_to_xyxy

    boxes = cxcyhw_to_xyxy(centers)
    b1, b2 = boxes[:, :, None, :], boxes[:, None, :, :]
    inter_wh = torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2])
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-6)
    own = torch.arange(boxes.shape[1], device=boxes.device)

    def partner(p):
        return torch.where(p[..., 0] == own, p[..., 1], p[..., 0])

    pa, pb = partner(pairs_a), partner(pairs_b)
    differ = (pairs_a != pairs_b).any(-1)
    iou_gap = (iou.gather(2, pa[..., None]) - iou.gather(2, pb[..., None]))[..., 0].abs()
    l1 = box_l1_size(boxes)
    size_gap = (l1 - l1.gather(1, pa)).abs()
    margin = torch.where(pa != pb, iou_gap, size_gap)[differ]
    return int(differ.sum()), (margin.max().item() if margin.numel() else 0.0)


def phase_whole_model(torch, service, variables, images):
    import numpy as np

    from object_detection_destr_tpu_torch.config import DestrConfig
    from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas
    from object_detection_destr_tpu_torch.data.transforms import letterbox_infer_transform
    from object_detection_destr_tpu_torch.models.convert import load_flax_variables
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    canvases, content = [], []
    for image in images:
        canvas, fh, fw = _letterbox_canvas(image, 640)
        canvases.append(canvas)
        content.append([fh, fw])
    prep = letterbox_infer_transform(
        torch.from_numpy(np.stack(canvases)).cuda(), torch.tensor(content), out_size=640
    )
    plain = load_flax_variables(
        build_destr(DestrConfig(use_flash_attention=False), "cuda"), variables
    )
    flash_choices, plain_choices = [], []
    with torch.inference_mode():
        with choices(record=flash_choices):
            flash_out = service.model(prep["images"], prep["pixel_valid"])
        with choices(record=plain_choices):
            plain_out = plain(prep["images"], prep["pixel_valid"])
        # the mini-detector's top-k and pair attention's IoU argmax are
        # discrete: where two candidates tie to within float32 noise, the two
        # runs may choose differently, and the outputs then differ by O(1).
        # The first such flip must be a near-tie (later ones may follow from
        # it); the outputs are then compared on the kernel run's choices.
        flips = first_flip(torch, flash_choices, plain_choices)
        if flips:
            log("whole model: the plain run chose otherwise at "
                + ", ".join(f"{k} (margin {m:.2e})" for k, m in flips))
            if flips[0][1] >= 1e-4:
                raise AssertionError(f"a discrete choice differs where it is no near-tie: {flips}")
            with choices(replay=flash_choices):
                plain_out = plain(prep["images"], prep["pixel_valid"])
            log("whole model: plain run repeated on the kernel run's choices")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-6)).item()

    errs = {
        "det/pred_class": (rel(flash_out[1]["pred_class"], plain_out[1]["pred_class"]), 2e-4),
        "det/pred_boxes": (rel(flash_out[1]["pred_boxes"], plain_out[1]["pred_boxes"]), 2e-4),
        "pred_class": (rel(flash_out[0]["pred_class"], plain_out[0]["pred_class"]), 1e-2),
        "pred_boxes": (rel(flash_out[0]["pred_boxes"], plain_out[0]["pred_boxes"]), 2e-3),
    }
    finite = all(torch.isfinite(t).all().item() for o in (flash_out, plain_out)
                 for part in o for t in part.values())
    log("whole model B=4, kernel vs plain: "
        + " ".join(f"{k}={v:.2e} (tol {t:.0e})" for k, (v, t) in errs.items())
        + f" topk flips={sum(k == 'topk' for k, _ in flips)} finite={finite}")
    bad = [k for k, (v, t) in errs.items() if not v < t]
    if bad or not finite:
        raise AssertionError(f"whole model out of tolerance: {bad}, finite={finite}")


# the kernels' device names in a torch.profiler trace, in the order of the
# counts (#1, #2, #3, #4, #9, #8): demangled template names, or mangled ones
# (ILb0E / ILb1E: the two-pass kernel's DKV = false / true)
KERNEL_NAME_PATTERNS = [r"flash_fwd_(tc|f32)_kernel", r"flash_bwd_(tc_)?kernel",
                        r"flash_two_pass_tc_kernel(<false|ILb0E)|flash_dq_kernel",
                        r"flash_two_pass_tc_kernel(<true|ILb1E)|flash_dkv_kernel",
                        r"fused_auction_kernel", r"(?<!fused_)auction_kernel"]


def trace_launches(launches: dict) -> list:
    """Launches of #1, #2, #3, #4, #9, #8 in a parsed trace's kernel counts."""
    import re

    counts = [0] * len(KERNEL_NAME_PATTERNS)
    for name, n in launches.items():
        for i, pattern in enumerate(KERNEL_NAME_PATTERNS):
            if re.search(pattern, name):
                counts[i] += n
                break
    return counts


def traced(torch, label, steps, run_steps):
    """Trace ``run_steps(scope)``, which runs ``steps`` steps, step i inside
    ``scope(i)``, under torch.profiler; returns the parsed trace
    (train/profiler.py) with ``per_step`` launches of #1/#2/#3/#4/#9/#8 read
    from the device events."""
    from object_detection_destr_tpu_torch.train.profiler import StepTrace, parse_trace

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build", "traces", label)
    shutil.rmtree(out_dir, ignore_errors=True)
    trace = StepTrace(out_dir)
    torch.cuda.synchronize()
    trace.start()
    run_steps(trace.step)
    parsed = parse_trace(trace.stop())
    if len(parsed["steps"]) != steps or parsed["busy_s"] <= 0.0:
        raise AssertionError(f"{label}: the trace holds {len(parsed['steps'])} steps, busy {parsed['busy_s']} s")
    counts = trace_launches(parsed["launches"])
    parsed["per_step"] = [c / steps for c in counts]
    parsed["step_busy_ms"] = statistics.median(s["busy_s"] * 1e3 for s in parsed["steps"])
    parsed["step_period_ms"] = statistics.median(s["period_s"] * 1e3 for s in parsed["steps"])
    return parsed


def _flat_params(torch, model):
    return torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])


def _hold_to_spread(label, eager, captured, controls=None):
    """Hold one captured sample to the eager samples' own spread. The eager
    step is not bit-reproducible (#2 adds dQ with float32 atomics, cuDNN's
    backward sums in its own order), so a right capture is one more sample
    of the eager spread: per quantity, the captured sample's distance to the
    mean of the eager samples must not exceed the largest distance between
    two eager samples (a sample's distance to the mean of K others is about
    sqrt((1 + 1/K) / 2) of a pair's, so a right capture passes with margin
    while the limit is no wider than the eager pairs). ``controls``: samples
    of planted faults, each of which must fail on at least one quantity, or
    the check could not see that fault. Returns the distances."""
    import itertools

    out = {}
    for key in eager[0]:
        mean = _mean_sample([e[key] for e in eager])
        limit = max(dist(a[key], b[key], key) for a, b in itertools.combinations(eager, 2))
        out[key] = {"captured": dist(captured[key], mean, key), "limit": limit,
                    "eager_to_mean": [dist(e[key], mean, key) for e in eager],
                    **{name: dist(c[key], mean, key) for name, c in (controls or {}).items()}}
    bad = [k for k, v in out.items() if not v["captured"] <= v["limit"]]
    blind = [name for name in controls or {} if all(v[name] <= v["limit"] for v in out.values())]
    if bad or blind:
        raise AssertionError(f"{label}: captured farther from the eager mean than two eager samples are apart in "
                             f"{bad}; planted faults the check does not see: {blind}; distances {out}")
    return out


def _rounded(x):
    """``x`` with every float at 4 significant digits, for the log."""
    if isinstance(x, float):
        return float(f"{x:.4g}")
    if isinstance(x, dict):
        return {k: _rounded(v) for k, v in x.items()}
    return [_rounded(v) for v in x] if isinstance(x, list) else x


def _mean_sample(samples):
    import torch

    stack = torch.stack([torch.as_tensor(x, dtype=torch.float64) for x in samples])
    return stack[0] + (stack - stack[0]).mean(0)  # equal samples give their own value, not a rounding of it


def dist(a, b, key):
    """The distance of two samples' ``key``: the mean absolute difference of
    the losses, the 2-norm of the difference of a vector (Adam's first
    moment, the parameters)."""
    import torch

    diff = torch.as_tensor(a, dtype=torch.float64) - torch.as_tensor(b, dtype=torch.float64)
    return float(diff.abs().mean() if key == "losses" else diff.norm())


def phase_seed_replay(torch, seed):
    """The flash seed read from device memory under a CUDA graph: a captured
    draw of DropoutRng's seed followed by kernel #1 (its keep mask read off
    its output, as in phase 3), replayed at steps 5 and 6 after reseeding the
    registered generator: each replay's seed and keep mask equal the eager
    draw's at that step and the plain Philox mask of that seed, and the two
    steps' masks differ."""
    from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    name, sq, sk, h, d, dv, _ = PATH_SITES[0]
    b, dtype = 2, torch.bfloat16
    rng = DropoutRng(seed, "cuda")
    operands = keep_mask_operands(torch, b, sq, sk, h, d, dv, dtype)  # made outside the graph: copies from the host

    def draw():
        s = rng.seed()
        return s, kernel_keep_mask(torch, fa, b, sq, sk, h, d, dv, dtype, RATE, s, operands)

    eager = {}
    for step in (5, 6):
        rng.begin_step(step)
        s, keep = draw()
        eager[step] = (s.clone(), keep.clone())
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(rng.generator)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rng.begin_step(0)
        draw()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        s_static, keep_static = draw()
    replayed = {}
    for step in (5, 6):
        rng.begin_step(step)
        graph.replay()
        replayed[step] = (s_static.clone(), keep_static.clone())
    torch.cuda.synchronize()
    checks = {}
    for step in (5, 6):
        (se, ke), (sr, kr) = eager[step], replayed[step]
        plain = fa._keep_mask(sr, RATE, b, h, sq, sk, "cuda")
        checks[step] = {"seed": int(sr), "seed_equal": torch.equal(se, sr), "keep_equal": torch.equal(ke, kr),
                        "plain_equal": torch.equal(kr, plain), "kept": kr.float().mean().item()}
    differ = not torch.equal(replayed[5][1], replayed[6][1]) and not torch.equal(replayed[5][0], replayed[6][0])
    del graph
    log(f"seed replay ({name}, B={b}, bf16, dropout {RATE}): replays at steps 5 and 6 {checks}; the two steps' "
        f"masks differ: {differ}")
    if not differ or not all(c["seed_equal"] and c["keep_equal"] and c["plain_equal"] and abs(c["kept"] - (1 - RATE))
                             < 0.005 for c in checks.values()):
        raise AssertionError(f"replayed seeds or keep masks wrong: {checks}, differ={differ}")
    return checks


def _state_tensors(state):
    """Every tensor a train step reads and writes in place: the parameters,
    the buffers (BatchNorm statistics), Adam's moments and its counters, and
    with gradient accumulation the accumulated mean and the mini-step."""
    opt = state.optimizer
    accumulation = [] if opt.accumulated is None else [opt.accumulated, opt._mini]
    return [*state.model.parameters(), *state.model.buffers(), *opt._m.values(), *opt._v.values(), opt._count,
            opt._notfinite, *accumulation]


def _restore(torch, state, snapshot, step):
    with torch.no_grad():
        for t, saved in zip(_state_tensors(state), snapshot):
            t.copy_(saved)
    state.step = step


def destr_capture_setup(torch, seed, extra):
    """The DESTR production recipe's (+ ``extra`` flags) state, device cache,
    transform, steps and augmentation seeds for :func:`phase_captured_train`."""
    from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader
    from object_detection_destr_tpu_torch.data.transforms import destr_train_transform
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.driver import _aug_seed, _make_loaders
    from object_detection_destr_tpu_torch.train.state import create_destr_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_step_core, make_destr_train_step

    config = recipe_config(list(extra) + ["--seed", str(seed)])
    cfg = config.train
    cache = DeviceCachedLoader(_make_loaders(config, 672, "destr")[0], "cuda")
    torch.manual_seed(seed)
    return {"state": create_destr_state(build_destr(config.destr, "cuda"), cfg, steps_per_epoch=len(cache)),
            "cache": cache, "train_step": make_destr_train_step(cfg), "step_core": make_destr_step_core(cfg),
            "transform": lambda raw, gen: destr_train_transform(raw["images"], raw["boxes"], raw["labels"],
                                                                raw["valid"], gen, out_size=cfg.image_size),
            "aug_seed": lambda step: _aug_seed(seed, step), "config": config}


EXACT_NOTE = (" (cuDNN held to deterministic engines for steps 0-4, so the eager samples are bit-equal; then the "
              "step captured again with its default engines, whose replay has the losses of an eager step)")


@contextlib.contextmanager
def _cudnn_deterministic(torch, on):
    """Inside, cuDNN picks only deterministic engines if ``on``; otherwise
    nothing changes."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = saved or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def phase_captured_train(torch, kernels, setup, per_step, label, exact=False):
    """A recipe's step on device-cached batches (``setup``: its state, cache,
    steps, transform and augmentation seeds), captured against eager from the
    same state and seed: the
    epoch runner takes step 0 (its eager warm-up on a side stream, then the
    capture); at each of steps 1-4 the state is cloned and, each from the
    clone, the eager per-step path runs EAGER_RUNS times (the first under
    torch.cuda.set_sync_debug_mode("error")), the graph replays once with
    the seeds of the capture's step 0 (a planted fault: the seed fixed at
    capture) and once with the step's own seeds, which is the state the run
    goes on from. The replay is held to the eager samples' spread
    (``_hold_to_spread``): Adam's first moment after each step (where only
    the summation order of #2's atomics and cuDNN's backward differ between
    eager samples) and the parameters, each relative to the step's own
    change, and the 4 steps' losses; the planted fault must fail. Then, in
    turns on the live state, CUDA-event step times (eager, captured,
    captured, eager, 3 steps each), a traced window of 3 steps of each (the
    device's busy time and idle share, and the launches a step read from the
    trace, ``per_step`` as the wrappers count them eagerly), and the peak
    memory of each.

    ``exact``: for a step whose only spread between eager samples is cuDNN's
    choice of nondeterministic engines (SSD's, whose extra blocks' weight
    gradients sum in a split order that changes from call to call). The
    capture and steps 1-4 then run with cuDNN held to deterministic engines,
    where eager samples are bit-equal, so the limit is 0 and the replay must
    be bit-equal to them. The step is then captured again with cuDNN's
    default engines, as the trainer runs it; its first replay's losses must
    equal an eager step's from the same cloned state, and the times, traces
    and peak memory are this capture's."""
    from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner

    state, cache, transform, train_step = setup["state"], setup["cache"], setup["transform"], setup["train_step"]
    _, idx = cache.epoch_index_matrix()
    rows = torch.from_numpy(idx).cuda()
    gen = torch.Generator(device="cuda")

    def eager_step(sync_debug=False):
        gen.manual_seed(setup["aug_seed"](state.step))
        raw = cache.gather(rows[state.step % len(rows)])
        if not sync_debug:
            return train_step(state, transform(raw, gen))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return train_step(state, transform(raw, gen))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def sample(metrics):
        out = {"losses": [float(v) for v in metrics.values()],
               "m": torch.cat([m.reshape(-1) for m in state.optimizer._m.values()]),
               "params": _flat_params(torch, state.model)}
        if state.optimizer.accumulated is not None:  # a mini-step that does not emit moves only this
            out["acc"] = state.optimizer.accumulated.clone()
        return out

    def rows_from(step, n):
        """The index rows of steps step .. step + n - 1 (the epoch's rows, repeated)."""
        return idx[[i % len(idx) for i in range(step, step + n)]]

    def capture(step):
        """A new runner, its warm-up and capture at ``step``; the memory they take."""
        runner = EpochRunner(state, setup["step_core"], transform, cache.data, setup["aug_seed"], len(cache))
        torch.cuda.synchronize()
        before, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        runner.run(rows_from(step, 1), step)
        memory = {"captured_peak": torch.cuda.max_memory_allocated() - before,
                  "held": torch.cuda.memory_allocated() - before, "pool": torch.cuda.memory_reserved() - reserved}
        if runner.graph is None or state.step != step + 1:
            raise AssertionError(f"{label}: no graph captured, or {state.step} steps")
        return runner, memory, [k.launches for k in kernels]  # the warm-up step and the capture call the wrappers

    with _cudnn_deterministic(torch, exact):
        runner, memory, capture_counts = capture(0)
        spread, losses = {}, {"eager": [[] for _ in range(EAGER_RUNS)], "captured": [], "seed_of_step_0": []}
        for step in range(1, TRAIN_STEPS + 1):
            snapshot = [t.detach().clone() for t in _state_tensors(state)]
            start = {"m": torch.cat([m.reshape(-1) for m in state.optimizer._m.values()]),
                     "params": _flat_params(torch, state.model)}
            if state.optimizer.accumulated is not None:
                start["acc"] = state.optimizer.accumulated.clone()
            eager = []
            for k in range(EAGER_RUNS):
                _restore(torch, state, snapshot, step)
                first = step == 1 and k == 0
                if first:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                eager.append(sample(eager_step(sync_debug=first)))
                if first:
                    eager_added = torch.cuda.max_memory_allocated() - base
            replays = {}
            for name, seeds_of in (("seed_of_step_0", 0), ("captured", step)):
                _restore(torch, state, snapshot, step)
                got = runner.run(rows_from(step, 1), seeds_of)
                replays[name] = sample({k: v[0] for k, v in got.items()})
            state.step = step + 1  # the run goes on from the replay at the step's own seeds
            del snapshot
            # each vector relative to the step's change (the eager samples' mean
            # change; absolute where the step changed nothing: a mini-step that
            # does not emit leaves the moments and the parameters)
            for key in start:
                change = _mean_sample([e[key] for e in eager]).to(start[key].device) - start[key].double()
                norm = float(change.norm()) or 1.0
                for smp in (*eager, *replays.values()):
                    smp[key] = ((smp[key].double() - start[key].double()) / norm).float()
            for k, e in enumerate(eager):
                losses["eager"][k] += e.pop("losses")
            for name, r in replays.items():
                losses[name] += r.pop("losses")
            spread[f"step {step}"] = _hold_to_spread(f"captured step {label}, step {step}", eager,
                                                     replays["captured"], {"seed_of_step_0": replays["seed_of_step_0"]})
            del eager, replays, start
        spread["losses"] = _hold_to_spread(
            f"captured step {label}, losses of steps 1-{TRAIN_STEPS}", [{"losses": e} for e in losses["eager"]],
            {"losses": losses["captured"]}, {"seed_of_step_0": {"losses": losses["seed_of_step_0"]}})["losses"]
    if exact:  # capture again with cuDNN's default engines, as the trainer runs
        del runner
        torch.cuda.empty_cache()
        runner, memory, capture_counts = capture(state.step)
        step = state.step
        snapshot = [t.detach().clone() for t in _state_tensors(state)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eager = sample(eager_step())
        eager_added = torch.cuda.max_memory_allocated() - base
        _restore(torch, state, snapshot, step)
        replay = sample({k: v[0] for k, v in runner.run(rows_from(step, 1), step).items()})
        del snapshot
        if eager["losses"] != replay["losses"]:
            raise AssertionError(f"{label}: the capture with cuDNN's default engines gives the losses "
                                 f"{replay['losses']} at step {step}, an eager step {eager['losses']}")
        spread[f"default engines, step {step}"] = {"losses": {"captured": dist(replay["losses"], eager["losses"],
                                                                              "losses"), "limit": 0.0}}
        del eager, replay
    torch.cuda.empty_cache()
    log(f"captured step {label}: step 0 the runner's warm-up and capture; steps 1-{TRAIN_STEPS} each from one "
        f"cloned state, {EAGER_RUNS} eager samples, the replay and a replay with step 0's seeds (planted fault); "
        f"distances to the eager mean (m: Adam's first moment, params: parameters, both as 2-norms relative to "
        f"the step's change, so a step that applied no update is at 1.0; losses: mean absolute difference over "
        f"the {TRAIN_STEPS} steps' losses) and limit = the largest eager pair{EXACT_NOTE if exact else ''} "
        f"{json.dumps(_rounded(spread))}; "
        f"the first "
        f"eager step ran under set_sync_debug_mode('error') without a host sync; wrapper calls of the warm-up and "
        f"the capture #1/#2/#3/#4/#9/#8/#5/#6/#7 {capture_counts}")

    def eager_steps(scope=lambda i: contextlib.nullcontext(), after=lambda: None):
        for _ in range(3):
            with scope(state.step):
                eager_step()
            after()

    def captured_steps(scope=lambda i: contextlib.nullcontext(), after=lambda: None):
        runner.run(rows_from(state.step, 3), state.step, after_step=after, step_scope=scope)

    # step times in turns, CUDA events between steps
    run_steps = {"eager": eager_steps, "captured": captured_steps}
    times = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        events = [torch.cuda.Event(enable_timing=True)]
        torch.cuda.synchronize()
        events[0].record()

        def mark():
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        run_steps[kind](after=mark)
        torch.cuda.synchronize()
        times[kind] += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    # a traced window of each: device busy time, idle share, launches a step
    windows = {kind: traced(torch, f"train_{label.replace(' ', '_')}_{kind}", 3, lambda scope: fn(scope=scope))
               for kind, fn in run_steps.items()}
    for kind, window in windows.items():
        if window["per_step"] != [float(n) for n in per_step[:6]]:
            raise AssertionError(f"captured step {label}: a traced {kind} step launched #1/#2/#3/#4/#9/#8 "
                                 f"{window['per_step']} times, not {list(per_step[:6])} (launch lead "
                                 f"{window['launch_lead_s']} s)")
    out = {"eager_ms": statistics.median(times["eager"]), "captured_ms": statistics.median(times["captured"]),
           "eager_ms_all": times["eager"], "captured_ms_all": times["captured"],
           "eager_step_peak_gb": eager_added / 1e9, "captured_peak_gb": memory["captured_peak"] / 1e9,
           "graph_held_gb": memory["held"] / 1e9, "reserved_added_gb": memory["pool"] / 1e9, "spread": spread,
           **{f"{kind}_{key}": window[key] for kind, window in windows.items()
              for key in ("idle_share", "step_busy_ms", "step_period_ms", "per_step", "unattributed")}}
    log(f"captured step {label}: step ms (CUDA events, in turns E C C E, 3 each) eager {out['eager_ms']:.2f} "
        f"({', '.join(f'{t:.2f}' for t in times['eager'])}), captured {out['captured_ms']:.2f} "
        f"({', '.join(f'{t:.2f}' for t in times['captured'])}); traced window of 3 steps: eager device busy "
        f"{out['eager_step_busy_ms']:.2f} ms a step of {out['eager_step_period_ms']:.2f}, idle share "
        f"{out['eager_idle_share']:.4f}; captured busy {out['captured_step_busy_ms']:.2f} ms of "
        f"{out['captured_step_period_ms']:.2f}, idle share {out['captured_idle_share']:.4f}; launches a step "
        f"from the trace #1/#2/#3/#4/#9/#8 eager {windows['eager']['per_step']} captured "
        f"{windows['captured']['per_step']}; peak memory above the state's (max_memory_allocated) of an eager "
        f"step {out['eager_step_peak_gb']:.2f} GB, of the runner's warm-up and capture "
        f"{out['captured_peak_gb']:.2f} GB, allocated after them (gradients, the graph's outputs) "
        f"{out['graph_held_gb']:.2f} GB, reserved by the allocator since the runner began (the graph's private "
        f"pool among it) {out['reserved_added_gb']:.2f} GB")
    del runner, state
    torch.cuda.empty_cache()
    return out


def phase_train_scan(torch, seed):
    """train.train.main with --device_cache --epoch_scan, 2 epochs on 64
    samples (8 steps) at hidden 256, against EAGER_RUNS runs of
    --device_cache alone (the per-step path; the first with --profile_dir,
    so steps 2 and 3 are traced, the range 2-4 cut by the 4-step epoch, and
    the trace parses): the scanned run's final parameters and logged losses
    within the per-step runs' own spread (``_hold_to_spread``); the cache's
    bytes and build seconds."""
    from object_detection_destr_tpu_torch.train import train as train_cli

    root = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    try:
        results = {}
        eager = ["eager_profiled"] + [f"eager_{i}" for i in range(1, EAGER_RUNS)]
        for name in eager + ["scan"]:
            extra = {"eager_profiled": ["--profile_dir", os.path.join(root, "trace")],
                     "scan": ["--epoch_scan"]}.get(name, [])
            argv = TRAIN_ARGS + ["--seed", str(seed), "--num_valid_samples", "0", "--epochs", "2", "--device_cache",
                                 "--checkpoint_dir", os.path.join(root, name), "--log_dir", os.path.join(root, name)]
            t0 = time.perf_counter()
            result = train_cli.main(argv + extra)
            torch.cuda.synchronize()
            with open(os.path.join(root, name, "metrics.jsonl")) as f:
                losses = [[v for k, v in r.items() if k.startswith("loss")] for r in map(json.loads, f)
                          if r.get("prefix") == "train"]
            results[name] = {"result": result, "wall": time.perf_counter() - t0, "losses": losses,
                             "params": _flat_params(torch, result["state"].model)}
            if result["state"].step != 2 * TRAIN_STEPS or len(losses) != 2 * TRAIN_STEPS:
                raise AssertionError(f"{name}: {result['state'].step} steps, {len(losses)} logged")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    scan = results["scan"]["result"]
    if not scan["epoch_scan"] or results["eager_1"]["result"]["epoch_scan"]:
        raise AssertionError("--epoch_scan did not run captured epochs, or --device_cache alone did")
    spread = _hold_to_spread("train.main scan", [{k: results[n][k] for k in ("losses", "params")} for n in eager],
                             {k: results["scan"][k] for k in ("losses", "params")})
    profile = results["eager_profiled"]["result"]["profile"]
    labels = [s["label"] for s in profile["steps"]]
    if labels != ["2", "3"] or not profile["busy_s"] > 0:  # steps 2-4 of an epoch of 4 steps
        raise AssertionError(f"--profile_dir traced steps {labels}, busy {profile['busy_s']} s")
    per_step = [c / len(labels) for c in trace_launches(profile["launches"])]
    if per_step != [18.0, 18.0, 0.0, 0.0, 1.0, 0.0]:
        raise AssertionError(f"--profile_dir trace: {per_step} launches of #1/#2/#3/#4/#9/#8 a step (launch lead "
                             f"{profile.get('launch_lead_s')} s)")
    cache = scan["device_cache"]
    out = {"spread": spread, "profile_idle_share": profile["idle_share"], "profile_busy_s": profile["busy_s"],
           "profile_window_s": profile["window_s"], "per_step": per_step, "cache": cache,
           "walls": {n: r["wall"] for n, r in results.items()},
           "step_ms": {n: statistics.median(r["result"]["step_ms"][1:]) for n, r in results.items()}}
    log(f"train.main --device_cache --epoch_scan, 2 epochs of 4 steps (hidden 256): distances to the per-step "
        f"runs' mean (losses: mean absolute difference, parameters: 2-norm of the difference) and limit = the "
        f"largest distance of two per-step runs {json.dumps(_rounded(spread))}; median step ms (CUDA events, after the first) "
        + ", ".join(f"{n} {v:.2f}" for n, v in out["step_ms"].items())
        + f"; --profile_dir steps {labels}: device busy {profile['busy_s'] * 1e3:.2f} ms of a "
        f"{profile['window_s'] * 1e3:.2f} ms window, idle share {profile['idle_share']:.4f}, launches a step "
        f"#1/#2/#3/#4/#9/#8 {per_step}; device cache " + ", ".join(
            f"{k} {v['bytes']} bytes in {v['build_seconds']:.2f} s" for k, v in cache.items()))
    return out


# ---- SSD300 (slice 6): no kernel of the nine lies on its path
SSD_B = 32
SSD_TRAIN_SAMPLES = 256  # the recipe's set cut to 8 batches
SSD_VALID_SAMPLES = 64
# scripts/train_prod_ssd.sh's recipe, the set cut to SSD_TRAIN_SAMPLES, one epoch
SSD_ARGS = [
    "--dataset", "synthetic", "--synthetic_size", "384", "--num_train_samples", str(SSD_TRAIN_SAMPLES),
    "--num_valid_samples", "0", "--augment_factor", "1", "--batch_size", str(SSD_B), "--compute_dtype", "bfloat16",
    "--num_cls", "20", "--hard_neg_mining", "paper", "--epochs", "1", "--lr", "1e-4", "--lr_backbone", "1e-4",
    "--lr_drop", "240", "--lr_warmup_steps", "500", "--skip_nonfinite", "100", "--device_cache",
    "--log_interval", "1",
]
SSD_REQUEST_SIZES = [(375, 500), (500, 375), (300, 300), (333, 500)]  # (H, W): VOC-like aspects
NO_LAUNCHES = (0,) * 9  # SSD's path launches none of #1-#9


def ssd_recipe_config(extra=()):
    """The Config that the SSD trainer builds from SSD_ARGS (+ ``extra``)."""
    from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser

    return config_from_args(get_parser("ssd").parse_args(SSD_ARGS + list(extra)), "ssd")


def ssd_capture_setup(torch, seed):
    """SSD_ARGS' state, device cache, transform, steps and augmentation seeds
    (offset 13, as the SSD driver's) for :func:`phase_captured_train`."""
    from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader
    from object_detection_destr_tpu_torch.data.transforms import ssd_train_transform
    from object_detection_destr_tpu_torch.models.ssd import build_ssd
    from object_detection_destr_tpu_torch.train.driver import _aug_seed, _make_loaders
    from object_detection_destr_tpu_torch.train.state import create_ssd_state
    from object_detection_destr_tpu_torch.train.steps import make_ssd_step_core, make_ssd_train_step

    config = ssd_recipe_config(["--seed", str(seed)])
    cfg, ssd_cfg = config.train, config.ssd
    cache = DeviceCachedLoader(_make_loaders(config, int(ssd_cfg.image_size * 1.28), "ssd")[0], "cuda")
    torch.manual_seed(seed)
    return {"state": create_ssd_state(build_ssd(ssd_cfg, "cuda"), cfg, steps_per_epoch=len(cache)),
            "cache": cache, "train_step": make_ssd_train_step(cfg, ssd_cfg),
            "step_core": make_ssd_step_core(cfg, ssd_cfg),
            "transform": lambda raw, gen: ssd_train_transform(raw["images"], raw["boxes"], raw["labels"],
                                                              raw["valid"], gen, out_size=ssd_cfg.image_size),
            "aug_seed": lambda step: _aug_seed(seed, step, 13), "config": config}


def ssd_step_parts(torch, setup, reps=3):
    """Where an eager SSD step goes (CUDA events, median of ``reps`` steps
    of ``make_ssd_train_step`` on the live state): the forward, the
    criterion, the backward (the loss's backward, from the criterion's end to
    the BatchNorm-statistics guard), the guard and the optimizer; then the
    same steps with the frozen VGG trunk's parameters out of autograd (its
    backward is not run at all), whose backward's difference is what the
    trunk's backward costs; and the criterion alone on detached head outputs,
    forward and its own backward."""
    from object_detection_destr_tpu_torch.losses.criterion import ssd_criterion
    from object_detection_destr_tpu_torch.train import steps

    state, cache, config = setup["state"], setup["cache"], setup["config"]
    gen = torch.Generator(device="cuda").manual_seed(setup["aug_seed"](0))
    batch = setup["transform"](cache.gather(torch.arange(SSD_B, device="cuda")), gen)
    marks = {}

    def mark(key):
        marks[key] = torch.cuda.Event(enable_timing=True)
        marks[key].record()

    def around(name, fn):
        def inner(*args, **kwargs):
            mark(name + ">")
            out = fn(*args, **kwargs)
            mark(name + "<")
            return out
        return inner

    originals = (steps.ssd_criterion, steps._guard_stats)
    steps.ssd_criterion = around("criterion", originals[0])
    steps._guard_stats = around("guard", originals[1])
    state.optimizer.step = around("optimizer", state.optimizer.step)
    hooks = [state.model.register_forward_pre_hook(lambda *_: mark("forward>")),
             state.model.register_forward_hook(lambda *_: mark("forward<"))]
    spans = {"forward": ("forward>", "forward<"), "criterion": ("criterion>", "criterion<"),
             "backward": ("criterion<", "guard>"), "stats guard": ("guard>", "guard<"),
             "optimizer": ("optimizer>", "optimizer<"), "step": ("step>", "step<")}
    train_step = steps.make_ssd_train_step(config.train, config.ssd)
    trunk = list(state.model.backbone.parameters())
    parts = {}
    try:
        for trunk_grads in (True, False):
            for p in trunk:
                p.requires_grad_(trunk_grads)
            runs = {k: [] for k in spans}
            for _ in range(reps):
                marks.clear()
                mark("step>")
                train_step(state, batch)
                mark("step<")
                torch.cuda.synchronize()
                for k, (a, b) in spans.items():
                    runs[k].append(marks[a].elapsed_time(marks[b]))
            parts[trunk_grads] = {k: statistics.median(v) for k, v in runs.items()}
    finally:
        steps.ssd_criterion, steps._guard_stats = originals
        del state.optimizer.step
        for hook in hooks:
            hook.remove()
        for p in trunk:
            p.requires_grad_(True)
    out = dict(parts[True])
    out["trunk backward"] = parts[True]["backward"] - parts[False]["backward"]
    out["step without the trunk's backward"] = parts[False]["step"]

    with torch.no_grad():
        outputs = state.model(batch["images"], train=False)
    anchors = steps.flat_anchors(config.ssd, "cuda")
    targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
    heads = {k: [t.detach().requires_grad_(True) for t in v] for k, v in outputs.items()}
    fwd, bwd = [], []
    for _ in range(reps + 1):
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        loss = ssd_criterion(heads, targets, anchors, loss_coef=config.train.coef_class_loss, mining="paper")["loss"]
        b.record()
        loss.backward()
        c.record()
        torch.cuda.synchronize()
        fwd.append(a.elapsed_time(b))
        bwd.append(a.elapsed_time(c) - a.elapsed_time(b))
    out["criterion alone"] = statistics.median(fwd[1:])
    out["criterion's backward alone"] = statistics.median(bwd[1:])

    # the criterion on the card against itself on the CPU, float32, on these head outputs
    ref = ssd_criterion({k: [t.detach().cpu() for t in v] for k, v in outputs.items()},
                        {k: v.cpu() for k, v in targets.items()}, anchors.cpu(), mining="paper")
    got = ssd_criterion({k: [t.detach() for t in v] for k, v in outputs.items()}, targets, anchors, mining="paper")
    err = max(abs(float(got[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-6) for k in ref)
    if not err <= 1e-4:  # float32 sums in other orders (tests/test_torch_ssd_criterion.py holds 1e-5 on the CPU)
        raise AssertionError(f"ssd_criterion on the card is {err:.2e} from the CPU's (relative), over 1e-4")
    out["criterion_rel_err_vs_cpu"] = err
    return out


def phase_ssd_train(torch, kernels, seed):
    """train-ssd-300: SSD_ARGS' step (B=32, 300 px, bf16, paper mining) on
    the device cache, captured through the EpochRunner against five eager
    steps from one cloned state at each of steps 1-4 (phase 6a's check and
    planted fault, the augmentation seeds of step 0), then where an eager
    step goes (:func:`ssd_step_parts`). The counts are zero before and read
    after: SSD launches none of the nine kernels."""
    setup = ssd_capture_setup(torch, seed)
    reset_counts(kernels)  # the SSD training path starts here
    captured = phase_captured_train(torch, kernels, setup, NO_LAUNCHES, "ssd 300", exact=True)
    counts = [k.launches for k in kernels]
    if counts != list(NO_LAUNCHES):
        raise AssertionError(f"SSD training launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}")
    parts = ssd_step_parts(torch, setup)
    n_trunk = sum(p.numel() for p in setup["state"].model.backbone.parameters())
    n_all = sum(p.numel() for p in setup["state"].model.parameters())
    log(f"train ssd 300: B={SSD_B}, 300px, bf16, paper mining, {n_all / 1e6:.2f} M parameters of which "
        f"{n_trunk / 1e6:.2f} M the frozen VGG trunk; step ms captured {captured['captured_ms']:.2f} "
        f"({SSD_B / captured['captured_ms'] * 1e3:.1f} images/s), eager {captured['eager_ms']:.2f} "
        f"({SSD_B / captured['eager_ms'] * 1e3:.1f} images/s); device idle share captured "
        f"{captured['captured_idle_share']:.4f}, eager {captured['eager_idle_share']:.4f}; peak above the state "
        f"eager {captured['eager_step_peak_gb']:.2f} GB, captured {captured['captured_peak_gb']:.2f} GB; launches "
        f"of the nine kernels {counts}")
    log("train ssd 300: where an eager step goes, ms (CUDA events, median of 3) "
        + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in parts.items()))
    out = {k: v for k, v in captured.items() if k != "spread"}
    out.update(parts=parts, launches=counts, spread=captured["spread"])
    del setup
    torch.cuda.empty_cache()
    return out


def phase_ssd_validation(torch, kernels, seed):
    """validate-ssd: ``train_ssd.main`` with SSD_ARGS at 128 training images
    (4 steps), a 64-image validation split, the EMA and --epoch_scan, one
    epoch: the best, EMA and last checkpoints; ``infer.evaluate.main
    --model ssd`` on the best reproduces the driver's sweep (mAP within 1e-6,
    the validation loss within 1e-5 relative); a resume from ``_last`` goes
    on from step 4 to 8. Launches of the nine kernels: none."""
    from object_detection_destr_tpu_torch.infer import evaluate
    from object_detection_destr_tpu_torch.train import train_ssd

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ssd_")
    steps = 128 // SSD_B
    try:
        base = SSD_ARGS + ["--seed", str(seed), "--num_train_samples", "128", "--num_valid_samples",
                           str(SSD_VALID_SAMPLES), "--checkpoint_dir", ckpt, "--log_dir", os.path.join(ckpt, "runs"),
                           "--save_as", "ssd_smoke", "--epoch_scan"]
        reset_counts(kernels)  # the SSD validation path starts here
        t0 = time.perf_counter()
        result = train_ssd.main(base + ["--ema_decay", "0.999"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        state, record = result["state"], result["history"][0]
        files = sorted(f for f in os.listdir(ckpt) if f.startswith("ssd_smoke"))
        if (state.step != steps or not result["epoch_scan"] or counts != list(NO_LAUNCHES)
                or files != ["ssd_smoke", "ssd_smoke_ema", "ssd_smoke_last"]):
            raise AssertionError(f"train_ssd: {state.step} steps, epoch_scan {result['epoch_scan']}, launches "
                                 f"{counts}, checkpoints {files}")
        scalars = [record["mAP"], record["ema_mAP"], *record["valid"].values(), *record["valid_ema"].values()]
        if not all(math.isfinite(v) for v in scalars) or set(record["valid"]) != {"loss", "class", "local"}:
            raise AssertionError(f"validation scalars: {record}")
        evaluated = evaluate.main(["--model", "ssd"] + base + ["--resume_from", "ssd_smoke"])
        if (abs(evaluated["map"] - record["mAP"]) > 1e-6 or evaluated["n_images"] != SSD_VALID_SAMPLES
                or abs(evaluated["val_loss"] - record["valid"]["loss"]) > 1e-5 * abs(record["valid"]["loss"])):
            raise AssertionError(f"evaluate --model ssd: {evaluated}, the driver's sweep {record}")
        del state, result
        torch.cuda.empty_cache()
        resumed = train_ssd.main(base + ["--resume", "--resume_from", "ssd_smoke_last"])
        torch.cuda.synchronize()
        if resumed["state"].step != 2 * steps or resumed["history"][-1]["step"] != 2 * steps:
            raise AssertionError(f"the resumed SSD run ended at step {resumed['state'].step}, not {2 * steps}")
        del resumed
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out = {"launches": counts, "wall_s": wall, "sweep_seconds": record["seconds"],
           "val_images_per_sec": SSD_VALID_SAMPLES / record["seconds"][0], "map": record["mAP"],
           "valid": record["valid"], "evaluate": evaluated}
    log(f"validate ssd: {steps} captured steps (--device_cache --epoch_scan), {SSD_VALID_SAMPLES} validation "
        f"images (live and EMA sweeps) through train_ssd.main in {wall:.1f} s; checkpoints {files}; mAP "
        f"{record['mAP']:.6f} ema_mAP {record['ema_mAP']:.6f} valid {record['valid']}; sweep seconds "
        f"{', '.join(f'{t:.2f}' for t in record['seconds'])} (host clock) = {out['val_images_per_sec']:.1f} "
        f"images/s; infer.evaluate --model ssd map {evaluated['map']:.6f} val_loss {evaluated['val_loss']:.4f} "
        f"gt_localized_frac {evaluated['gt_localized_frac']:.4f}; resume went on from step {steps} to "
        f"{2 * steps}; launches of the nine kernels {counts}")
    return out


def eager_predict_ssd(torch, service, image):
    """``service.predict_image`` for SSD with the model run eagerly (the
    host stretch, the normalization, the forward and ssd_predict)."""
    from object_detection_destr_tpu_torch.data.loader import _resize_canvas
    from object_detection_destr_tpu_torch.data.transforms import normalize_imagenet
    from object_detection_destr_tpu_torch.infer.predict import ssd_predict

    images = normalize_imagenet(torch.from_numpy(_resize_canvas(image, service.image_size)[None]).to(service.device))
    with torch.inference_mode():
        dets = {k: v.cpu().numpy() for k, v in
                ssd_predict(service.model(images), service._anchors, score_thresh=service.score_thresh).items()}
    keep = dets["valid"][0]
    return {"boxes": dets["boxes"][0][keep].tolist(), "scores": dets["scores"][0][keep].tolist(),
            "labels": dets["labels"][0][keep].tolist()}


def phase_ssd_serving(torch, kernels, seed, images):
    """serve-ssd-300: ``build_service --model ssd`` with seeded random
    weights (flax's initialisers, written as the .npz the server loads),
    the B=1 predict captured at startup; 8 requests (four aspect ratios,
    twice) as graph replays and the same 8 eagerly, the detections equal;
    latencies; a torch.profiler trace of 4 requests of each (device busy time,
    idle share); the model forward on the card against the CPU's (float32,
    TF32 off, 1e-4 of each head's largest value). Launches of the nine
    kernels: none."""
    from object_detection_destr_tpu_torch.config import SSDConfig
    from object_detection_destr_tpu_torch.infer.server import build_service, get_parser
    from object_detection_destr_tpu_torch.models.convert import flax_variables_from_state_dict, save_variables_npz
    from object_detection_destr_tpu_torch.models.ssd import build_ssd

    weights_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build")
    os.makedirs(weights_dir, exist_ok=True)
    torch.manual_seed(seed)
    save_variables_npz(flax_variables_from_state_dict(build_ssd(SSDConfig(), "cpu")),
                       os.path.join(weights_dir, "chip_smoke_ssd.npz"))
    args = get_parser().parse_args(["--model", "ssd", "--checkpoint_dir", weights_dir, "--weights",
                                    "chip_smoke_ssd.npz", "--score_thresh", "0.0"])
    reset_counts(kernels)  # the SSD serving path starts here
    t0 = time.perf_counter()
    service = build_service(args)  # default: GPU, 300 px, stretch, the predict captured
    built_s = time.perf_counter() - t0
    if service.graph is None or service.image_size != 300 or service.letterbox:
        raise AssertionError("the SSD service captured no graph, or is not at 300 px stretched")

    latencies, eager_latencies, served = [], [], []
    for rnd in range(2):
        for image in images:
            t0 = time.perf_counter()
            dets = service.predict_image(image)
            latencies.append((time.perf_counter() - t0) * 1e3)
            n = len(dets["scores"])
            if not 0 < n <= 200 or not all(0.0 <= v <= 1.0 for v in dets["scores"]) or any(
                    not (0.0 <= c <= 1.0) for box in dets["boxes"] for c in box) or any(
                    not 0 <= c < 20 for c in dets["labels"]):
                raise AssertionError(f"SSD detections out of range or {n} of them")
            if rnd == 0:
                served.append(dets)
    counts = [k.launches for k in kernels]
    if counts != list(NO_LAUNCHES):
        raise AssertionError(f"SSD serving launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}")
    for rnd in range(2):
        for image, captured_dets in zip(images, served):
            t0 = time.perf_counter()
            dets = eager_predict_ssd(torch, service, image)
            eager_latencies.append((time.perf_counter() - t0) * 1e3)
            if dets != captured_dets:
                raise AssertionError("the captured SSD predict's detections differ from the eager forward's")
    windows = {}
    for kind, predict in (("captured", service.predict_image),
                          ("eager", lambda image: eager_predict_ssd(torch, service, image))):
        def requests(scope, predict=predict):
            for i, image in enumerate(images):
                with scope(i):
                    predict(image)
        windows[kind] = traced(torch, f"serve_ssd_{kind}", len(images), requests)

    # the forward on the card against the CPU's, float32, one stretched request
    from object_detection_destr_tpu_torch.data.loader import _resize_canvas
    from object_detection_destr_tpu_torch.data.transforms import normalize_imagenet

    x = normalize_imagenet(torch.from_numpy(_resize_canvas(images[0], 300)[None]))
    cpu_model = build_ssd(SSDConfig(), "cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in service.model.state_dict().items()})
    with torch.inference_mode():
        ref, got = cpu_model(x), service.model(x.cuda())
    err = max(float((g.cpu() - r).abs().max() / r.abs().max()) for key in ("boxes", "conf")
              for g, r in zip(got[key], ref[key]))
    if not err <= 1e-4:
        raise AssertionError(f"the SSD forward on the card is {err:.2e} from the CPU's, over 1e-4")
    forward_ms = time_cuda(torch, lambda: service.model(x.cuda()))
    timing = {"captured_ms": statistics.median(latencies), "captured_max_ms": max(latencies),
              "eager_ms": statistics.median(eager_latencies), "eager_max_ms": max(eager_latencies),
              "forward_ms": forward_ms, "forward_rel_err_vs_cpu": err, "built_s": built_s, "launches": counts,
              **{f"{kind}_{key}": w[key] for kind, w in windows.items()
                 for key in ("idle_share", "step_busy_ms", "step_period_ms")}}
    log(f"serve ssd 300: service built (warm-up and capture) in {built_s:.1f} s; {len(latencies)} captured "
        f"requests, detections a request {[len(d['scores']) for d in served]}, equal to the eager forward's; "
        f"latency ms captured median {timing['captured_ms']:.2f} max {timing['captured_max_ms']:.2f} (all: "
        f"{', '.join(f'{t:.2f}' for t in latencies)}), eager median {timing['eager_ms']:.2f} max "
        f"{timing['eager_max_ms']:.2f}; traced 4 requests: " + "; ".join(
            f"{kind} device busy {w['step_busy_ms']:.3f} ms a request of {w['step_period_ms']:.3f}, idle share "
            f"{w['idle_share']:.4f}" for kind, w in windows.items())
        + f"; forward B=1 f32 {forward_ms:.2f} ms (CUDA events), {err:.2e} from the CPU's; launches of the nine "
        f"kernels {counts}")
    return service, timing


def phase_cli(torch, cases):
    """The CLI's array function (``infer.cli.predict_arrays``, eager) on the
    card for each served model and image (``cases``: kind -> (service,
    images)), against the server's captured predict on the same image: the
    same detections (labels and counts equal, boxes and scores within
    1e-5)."""
    import numpy as np

    from object_detection_destr_tpu_torch.infer.cli import predict_arrays

    worst = {}
    for kind, (service, images) in cases.items():
        worst[kind] = 0.0
        for image in images:
            dets = predict_arrays(service.model, kind, [image], service.image_size, service.score_thresh,
                                  letterbox=service.letterbox)
            keep = dets["valid"][0]
            want = service.predict_image(image)
            if dets["labels"][0][keep].tolist() != want["labels"]:
                raise AssertionError(f"cli {kind}: labels or counts differ from the server's")
            for key in ("boxes", "scores"):
                diff = float(np.abs(dets[key][0][keep] - np.asarray(want[key], np.float32)).max())
                worst[kind] = max(worst[kind], diff)
        if not worst[kind] <= 1e-5:
            raise AssertionError(f"cli {kind}: detections {worst[kind]:.2e} from the server's")
    log("cli: predict_arrays equals the captured server on " + ", ".join(
        f"{len(images)} {kind} images" for kind, (_, images) in cases.items())
        + f"; largest box / score difference {worst}")
    return worst


# ---- slice 7: training on real image files (WIDER FACE format)
REAL_TRAIN_IMAGES = 64  # four mini-steps of B=16, two updates at k = 2
REAL_VALID_IMAGES = 16  # one validation batch
REAL_WIDTH = 1024  # WIDER FACE's images are 1024 wide, 0.5-1.5 as tall
ACCUM = 2
REAL_FLAGS = ["--letterbox", "--grad_accum_steps", str(ACCUM), "--moment_dtype", "bfloat16", "--opt_layout",
              "grouped", "--rng_impl", "threefry"]
REAL_CANVAS = 672
# #1-#9 a remat micro-step: #1 twice a block (the forward and its recomputation)
REMAT_LAUNCHES = [36, 18, 0, 0, 1, 0, 0, 0, 0]


def real_args(root, seed, extra=()):
    """The production recipe on a WIDER FACE tree with the JAX package's
    training options (TRAIN_ARGS' synthetic flags are overridden or unused)."""
    return TRAIN_ARGS + ["--dataset", "widerface", "--data_root", root, *REAL_FLAGS, "--seed", str(seed), *extra]


def write_widerface_tree(root, seed):
    """A WIDER FACE tree written in the reader's format: seeded JPEGs 1024
    wide and 0.5-1.5 of that tall (a smooth coloured background, 1-40 bright
    faces of 8-170 px), REAL_TRAIN_IMAGES in train and REAL_VALID_IMAGES in
    val, each list closed by a 0-count entry with its dummy row. Returns the
    bytes written."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wider_face_split"), exist_ok=True)
    written = 0
    for split, n in (("train", REAL_TRAIN_IMAGES), ("val", REAL_VALID_IMAGES)):
        lines = []
        for i in range(n):
            w = REAL_WIDTH
            h = int(round(w * rng.uniform(0.5, 1.5)))
            coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
            image = np.array(Image.fromarray(coarse).resize((w, h), Image.BILINEAR))
            rows = []
            for _ in range(int(rng.integers(1, 41))):
                fw = int(rng.integers(8, w // 6))
                fh = min(int(fw * rng.uniform(1.0, 1.4)), h - 1)
                x, y = int(rng.integers(0, w - fw)), int(rng.integers(0, h - fh))
                image[y:y + fh, x:x + fw] = rng.integers(120, 256, 3)
                rows.append(f"{x} {y} {fw} {fh} 0 0 0 0 0 0")
            rel = f"{i % 8}--Event/{split}_{i}.jpg"
            path = os.path.join(root, f"WIDER_{split}", "images", rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(image).save(path, quality=90)
            written += os.path.getsize(path)
            lines += [rel, str(len(rows)), *rows]
        lines += [rel, "0", "0 0 0 0 0 0 0 0 0 0"]
        with open(os.path.join(root, "wider_face_split", f"wider_face_{split}_bbx_gt.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return written


def phase_native_pool(root):
    """The loader's native pool on the tree's first 16 train images at the
    recipe's canvas against PIL's decode and cv2's INTER_LINEAR resize (the
    99th percentile of the difference at most 2 grey levels); host images/s
    of the pool's path (the fused JPEG decode where libjpeg built, else PIL's
    decode over the loader's threads and the native batch_resize), of PIL +
    cv2 one image after another, and of the letterbox path the training run
    takes."""
    import numpy as np
    import cv2
    from PIL import Image

    from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset
    from object_detection_destr_tpu_torch.runtime import native

    ds = build_dataset("widerface", root, "train")
    idxs = np.arange(TRAIN_B)
    if not native.is_available():
        raise AssertionError(f"the native resize library did not build: {native.unavailable_reason('resize')}")
    jpeg = native.jpeg_available()
    if not jpeg:
        log(f"native pool: the JPEG decode library is unavailable on this host "
            f"({native.unavailable_reason('jpeg')}), so the fused decode is unverified here; holding the "
            f"decoded-array path (PIL decode, native batch_resize)")

    def pil_cv2():
        return np.stack([cv2.resize(np.asarray(Image.open(ds.samples[i][0]).convert("RGB")),
                                    (REAL_CANVAS, REAL_CANVAS), interpolation=cv2.INTER_LINEAR) for i in idxs])

    def timed_host(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, TRAIN_B / statistics.median(times)

    kw = dict(batch_size=TRAIN_B, canvas_size=REAL_CANVAS, max_targets=300, shuffle=False, prefetch=0)
    stretch, letterbox = DetectionLoader(ds, **kw), DetectionLoader(ds, letterbox=True, **kw)
    batch, native_rate = timed_host(lambda: stretch._make_batch(idxs))
    ref, pil_rate = timed_host(pil_cv2)
    _, letterbox_rate = timed_host(lambda: letterbox._make_batch(idxs))
    diff = np.abs(batch["images"].astype(int) - ref.astype(int))
    p99, worst = float(np.percentile(diff, 99)), int(diff.max())
    out = {"path": "jpeg" if jpeg else "decoded", "p99": p99, "max": worst, "native_images_per_sec": native_rate,
           "pil_cv2_images_per_sec": pil_rate, "letterbox_images_per_sec": letterbox_rate,
           "sizes": [tuple(Image.open(ds.samples[i][0]).size[::-1]) for i in idxs[:4]]}
    log(f"native pool ({out['path']} path) on {TRAIN_B} WIDER-like JPEGs (1024 wide; first sizes (h, w) "
        f"{out['sizes']}) onto the {REAL_CANVAS} canvas: against PIL + cv2 99th percentile {p99:.1f}, max {worst} "
        f"grey levels; host images/s (B={TRAIN_B}, canvas {REAL_CANVAS}, median of 3) native path "
        f"{native_rate:.1f}, PIL + cv2 one by one {pil_rate:.1f}, the letterbox path (PIL decode, PyTorch resize) "
        f"{letterbox_rate:.1f}")
    if p99 > 2:
        raise AssertionError(f"native pool differs from PIL + cv2: 99th percentile {p99} grey levels")
    return out


def phase_real_cli(torch, kernels, seed, root):
    """train.train.main on the tree with --letterbox --grad_accum_steps 2
    --moment_dtype bfloat16 --opt_layout grouped --rng_impl threefry at the
    production width: one epoch of 4 mini-steps (2 updates) and the
    validation sweep (1 batch), eager, then the same with --device_cache
    --epoch_scan. Counts set to 0 just before each run and read just after:
    eager, 18 / 18 / 1 of #1 / #2 / #9 a mini-step and 18 / 0 / 1 a validation
    batch; captured, the runner's warm-up step and its capture call the
    wrappers (a replay does not) and the sweep. Moments bfloat16, 2 updates
    applied, the accumulation closed, finite losses."""
    from object_detection_destr_tpu_torch.train import train as train_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_")
    out = {}
    try:
        for name, extra in (("eager", []), ("scan", ["--device_cache", "--epoch_scan"])):
            d = os.path.join(tmp, name)
            argv = real_args(root, seed, ["--checkpoint_dir", d, "--log_dir", d, *extra])
            reset_counts(kernels)  # the main path starts here
            t0 = time.perf_counter()
            result = train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = [k.launches for k in kernels]  # read just after the main path
            state, opt = result["state"], result["state"].optimizer
            steps = state.step
            calls = steps if name == "eager" else 2  # the scan's replays call no wrapper
            want = [18 * calls + 18, 18 * calls, 0, 0, calls + 1, 0, 0, 0, 0]
            moments = {m.dtype for m in opt.m.values()}
            metrics = result["metrics"]
            if (steps, opt.count, opt.mini_step) != (REAL_TRAIN_IMAGES // TRAIN_B, steps // ACCUM, 0):
                raise AssertionError(f"real data {name}: {steps} mini-steps, {opt.count} updates, mini-step "
                                     f"{opt.mini_step}")
            if counts != want or moments != {torch.bfloat16} or opt.layout != "grouped" \
                    or result["epoch_scan"] != (name == "scan"):
                raise AssertionError(f"real data {name}: launches {counts} (want {want}), moments {moments}, layout "
                                     f"{opt.layout}, epoch_scan {result['epoch_scan']}")
            if not metrics or not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"real data {name}: non-finite or missing losses {metrics}")
            with open(os.path.join(d, "metrics.jsonl")) as f:
                logged = sum(1 for r in map(json.loads, f) if r.get("prefix") == "train")
            events = [f for f in os.listdir(d) if f.startswith("events.out.tfevents")]
            out[name] = {"wall": wall, "launches": counts, "step_ms": result["step_ms"],
                         "images_per_sec": result["images_per_sec"], "val_map": result["map"],
                         "cache": result["device_cache"], "tensorboard_events": len(events), "logged": logged}
            log(f"real data train.main {name} ({' '.join(REAL_FLAGS)}{' ' + ' '.join(extra) if extra else ''}): "
                f"{steps} mini-steps, {opt.count} updates in {wall:.1f} s with the validation sweep; launches "
                f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}; step ms (CUDA events) "
                f"{', '.join(f'{t:.1f}' for t in result['step_ms'])}; epoch images/s {result['images_per_sec']:.1f}; "
                f"last losses " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                + f"; mAP {result['map']:.4f}; TensorBoard event files {len(events)}, train records {logged}"
                + (f"; device cache " + ", ".join(f"{k} {v['bytes']} bytes in {v['build_seconds']:.2f} s"
                                                  for k, v in result["device_cache"].items()) if extra else ""))
            del result, state
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def real_capture_setup(torch, seed, root):
    """destr_capture_setup's dictionary for the real-data recipe: the WIDER
    tree letterboxed into a device cache, the letterbox train transform (the
    cache's content extents), accumulation over 2 mini-steps, bfloat16
    moments, the grouped layout."""
    from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader
    from object_detection_destr_tpu_torch.data.transforms import destr_train_transform
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser
    from object_detection_destr_tpu_torch.train.driver import _aug_seed, _make_loaders
    from object_detection_destr_tpu_torch.train.state import create_destr_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_step_core, make_destr_train_step

    config = config_from_args(get_parser("destr").parse_args(real_args(root, seed)), "destr")
    cfg = config.train
    cache = DeviceCachedLoader(_make_loaders(config, REAL_CANVAS, "destr")[0], "cuda")
    torch.manual_seed(seed)
    return {"state": create_destr_state(build_destr(config.destr, "cuda"), cfg, steps_per_epoch=len(cache)),
            "cache": cache, "config": config, "train_step": make_destr_train_step(cfg),
            "step_core": make_destr_step_core(cfg),
            "transform": lambda raw, gen: destr_train_transform(raw["images"], raw["boxes"], raw["labels"],
                                                                raw["valid"], gen, raw["content_hw"],
                                                                out_size=cfg.image_size),
            "aug_seed": lambda step: _aug_seed(seed, step)}


def phase_real_ministeps(torch, setup):
    """Mini-steps 1 and 2 of the real-data recipe, eager, from the fresh
    state: the parameters and moments do not move on the first (the
    accumulator does), and move on the second (one update applied); the
    state is put back afterwards."""
    state, cache = setup["state"], setup["cache"]
    _, idx = cache.epoch_index_matrix()
    gen = torch.Generator(device="cuda")
    snapshot = [t.detach().clone() for t in _state_tensors(state)]
    before = _flat_params(torch, state.model)
    seen = []
    for step in range(2):
        gen.manual_seed(setup["aug_seed"](state.step))
        batch = setup["transform"](cache.gather(torch.from_numpy(idx[step]).cuda()), gen)
        if "pixel_valid" not in batch or bool(batch["pixel_valid"].all()):
            raise AssertionError("letterbox training: no pixel_valid mask, or no padding in the crops")
        setup["train_step"](state, batch)
        seen.append({"moved": not torch.equal(_flat_params(torch, state.model), before),
                     "count": state.optimizer.count, "mini_step": state.optimizer.mini_step,
                     "acc_norm": float(state.optimizer.accumulated.norm())})
    _restore(torch, state, snapshot, 0)
    del snapshot
    log(f"real data mini-steps from the fresh state: {seen}")
    if [s["moved"] for s in seen] != [False, True] or [s["count"] for s in seen] != [0, 1] \
            or seen[0]["acc_norm"] == 0.0 or seen[1]["acc_norm"] != 0.0:
        raise AssertionError(f"accumulation: parameters should hold on mini-step 1 and move on 2: {seen}")
    return seen


def phase_remat(torch, kernels, setup):
    """DestrConfig(remat=True) through the API at the real-data recipe's
    width: one micro-step (forward, matcher, criteria, backward; at mini-step
    0 of 2 the optimizer only accumulates, so the gradients are read off the
    parameters) from one cloned state, one seed, dropout 0.3, the CUDA
    kernels, without remat EAGER_RUNS times and with remat once: the remat
    gradients and losses within the eager samples' spread (``_hold_to_spread``),
    and a remat micro-step whose recomputation draws afresh (the replay of
    the forward's draws switched off, a planted fault) outside it. Launches
    of #1 / #2 / #9 a micro-step with and without remat (#1 twice a block
    with remat: forward and recomputation), peak memory above the state and
    the step time (CUDA events, median of 3) of each. Returns (the numbers,
    the remat state at step 0, for :func:`phase_captured_train`)."""
    from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.state import create_destr_state

    config, cache, core = setup["config"], setup["cache"], setup["step_core"]
    plain = setup["state"]
    model = build_destr(dataclasses.replace(config.destr, remat=True), "cuda")
    model.load_state_dict(plain.model.state_dict())
    remat = create_destr_state(model, config.train, steps_per_epoch=len(cache))
    if not (model.encoder.remat and model.decoder.remat):
        raise AssertionError("DestrConfig(remat=True) built blocks without remat")
    _, idx = cache.epoch_index_matrix()
    gen = torch.Generator(device="cuda").manual_seed(setup["aug_seed"](0))
    batch = setup["transform"](cache.gather(torch.from_numpy(idx[0]).cuda()), gen)
    step = 0

    def micro(state, counts=None):
        snapshot = [t.detach().clone() for t in _state_tensors(state)]
        state.rng.begin_step(step)
        if counts is not None:
            reset_counts(kernels)
        metrics = core(state, batch)
        if counts is not None:
            counts.extend(k.launches for k in kernels)
        out = {"losses": [float(v) for v in metrics.values()],
               "grads": torch.cat([p.grad.reshape(-1).float() for p in state.model.parameters()])}
        _restore(torch, state, snapshot, step)
        return out

    def timed_micro(state):
        """(peak bytes above the state of a micro-step, its median ms over 3)."""
        snapshot = [t.detach().clone() for t in _state_tensors(state)]
        state.optimizer.zero_grad()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state.rng.begin_step(step)
        core(state, batch)
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_cuda(torch, lambda: core(state, batch), reps=3, warmup=0)
        _restore(torch, state, snapshot, step)
        state.optimizer.zero_grad()
        return peak, ms

    counts = {"plain": [], "remat": []}
    eager = [micro(plain, counts["plain"] if i == 0 else None) for i in range(EAGER_RUNS)]
    with_remat = micro(remat, counts["remat"])
    original = DropoutRng.taped
    DropoutRng.taped = lambda self, tape, replay: contextlib.nullcontext()  # the planted fault
    try:
        no_replay = micro(remat)
    finally:
        DropoutRng.taped = original
    spread = _hold_to_spread("remat gradients", eager, with_remat, {"no_replay": no_replay})
    del eager, with_remat, no_replay
    plain_peak, plain_ms = timed_micro(plain)
    remat_peak, remat_ms = timed_micro(remat)
    want = {"plain": [18, 18, 0, 0, 1, 0, 0, 0, 0], "remat": REMAT_LAUNCHES}
    out = {"spread": spread, "launches": counts, "plain_peak_gb": plain_peak / 1e9, "remat_peak_gb": remat_peak / 1e9,
           "plain_ms": plain_ms, "remat_ms": remat_ms}
    log(f"remat (DestrConfig(remat=True), hidden {config.destr.hidden_dim}, B={TRAIN_B}, bf16, dropout "
        f"{config.destr.dropout}): gradients and losses of one micro-step, distances to the mean of {EAGER_RUNS} "
        f"micro-steps without remat (2-norm; losses mean absolute difference), limit the largest eager pair, "
        f"no_replay the planted fault {json.dumps(_rounded(spread))}; launches #1/#2/#3/#4/#9/#8/#5/#6/#7 a "
        f"micro-step without remat {counts['plain']}, with {counts['remat']}; peak memory above the state "
        f"(max_memory_allocated) {plain_peak / 1e9:.2f} GB without, {remat_peak / 1e9:.2f} GB with; micro-step "
        f"ms (CUDA events, median of 3) {plain_ms:.2f} without, {remat_ms:.2f} with")
    if counts != want:
        raise AssertionError(f"remat launches {counts} (want {want})")
    if not remat_peak < plain_peak:
        raise AssertionError(f"remat's peak {remat_peak} bytes is not below {plain_peak}")
    del model
    torch.cuda.empty_cache()
    return out, remat


def phase_layouts(torch, setup):
    """One AdamW update of each layout (per-leaf, grouped, flat) in float32
    from one state and one gradient (the recipe's lr 1e-4 / 1e-5, clip 0.1,
    skip-non-finite 100; constant lrs, as the flat layout takes no
    schedule): the parameters bit-equal across layouts. The update's time
    (CUDA events, median) for each layout and moment dtype."""
    from object_detection_destr_tpu_torch.train.optim import AdamW

    state, cache = setup["state"], setup["cache"]
    model = state.model
    _, idx = cache.epoch_index_matrix()
    gen = torch.Generator(device="cuda").manual_seed(setup["aug_seed"](0))
    snapshot = [t.detach().clone() for t in _state_tensors(state)]
    state.rng.begin_step(0)
    setup["step_core"](state, setup["transform"](cache.gather(torch.from_numpy(idx[0]).cuda()), gen))
    grads = [p.grad.detach().clone() for p in model.parameters()]
    _restore(torch, state, snapshot, 0)
    start = [p.detach().clone() for p in model.parameters()]
    results, times = {}, {}
    for layout, dtype in (("per-leaf", torch.float32), ("grouped", torch.float32), ("flat", torch.float32),
                          ("per-leaf", torch.bfloat16), ("grouped", torch.bfloat16)):
        with torch.no_grad():
            for p, s0 in zip(model.parameters(), start):
                p.copy_(s0)
        for p, g in zip(model.parameters(), grads):
            p.grad = g.clone()
        opt = AdamW(model, lr=1e-4, lr_backbone=1e-5, grad_clip=0.1, skip_nonfinite=100, layout=layout,
                    moment_dtype=dtype)
        opt.step()
        if dtype == torch.float32:
            results[layout] = _flat_params(torch, model)
        times[f"{layout} {str(dtype).removeprefix('torch.')}"] = time_cuda(torch, opt.step, reps=5, warmup=1)
        del opt
    with torch.no_grad():
        for p, s0 in zip(model.parameters(), start):
            p.copy_(s0)
    _restore(torch, state, snapshot, 0)
    for p in model.parameters():
        p.grad = None
    equal = {name: torch.equal(v, results["per-leaf"]) for name, v in results.items()}
    moved = not torch.equal(results["per-leaf"], torch.cat([s0.reshape(-1).float() for s0 in start]))
    del snapshot, grads, start, results
    torch.cuda.empty_cache()
    log(f"optimizer layouts, one float32 update from one state and gradient: parameters bit-equal to per-leaf "
        f"{equal} (moved: {moved}); update ms (CUDA events, median of 5) "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    if not all(equal.values()) or not moved:
        raise AssertionError(f"layouts disagree: {equal}, moved {moved}")
    return {"equal": equal, "update_ms": times}


def phase_real_data(torch, kernels, seed):
    """Phase 14, train-real-data: (a) a WIDER FACE tree on disk, (b) the
    native pool against PIL + cv2, (c) train.main on it with the JAX
    package's training options, eager and captured, mini-steps 1 and 2, and
    the captured step held to five eager steps (phase 6a's check), (d)
    remat against the step without it, and its captured step held to five
    eager remat steps in the same way, (e) the optimizer layouts."""
    root = tempfile.mkdtemp(prefix="chip_smoke_wider_")
    t0 = time.perf_counter()
    try:
        written = write_widerface_tree(root, seed)
        log(f"real data: a WIDER FACE tree of {REAL_TRAIN_IMAGES} + {REAL_VALID_IMAGES} JPEGs (1024 wide, 1-40 "
            f"faces, a 0-count entry each split), {written / 1e6:.1f} MB, written in {time.perf_counter() - t0:.1f} s")
        pool = phase_native_pool(root)
        cli = phase_real_cli(torch, kernels, seed, root)
        setup = real_capture_setup(torch, seed, root)
        ministeps = phase_real_ministeps(torch, setup)
        layouts = phase_layouts(torch, setup)
        remat, remat_state = phase_remat(torch, kernels, setup)
        remat["captured"] = phase_captured_train(torch, kernels, {**setup, "state": remat_state},
                                                 REMAT_LAUNCHES[:6], "real data remat")
        del remat_state
        torch.cuda.empty_cache()
        captured = phase_captured_train(torch, kernels, setup, (18, 18, 0, 0, 1, 0), "real data")
        del setup
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"real data phase: {time.perf_counter() - t0:.1f} s")
    return {"pool": pool, "cli": cli, "ministeps": ministeps, "layouts": layouts, "remat": remat,
            "captured": captured}


IMPORT_STEPS = 2  # train steps resumed from each imported checkpoint
STAGE_TOL = 1e-4  # backbone parity: of each stage's (conv4_3's) largest |value|, float32, TF32 off
SERVE_TOL = 1e-5  # a served answer against its source model's own (phase 11's; bit-equal expected)
PROFILE_STEPS = 3
PROFILE_OVERLAP = 0.05  # the kernels' summed time a step may exceed the device's busy time by this share


def repo_module(name, relpath):
    """A module of the repo outside the port (``tools/``, ``tests/``), loaded
    from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                                     relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _beside_card(card, label, fn, *args, phase="import"):
    """``fn(*args)``, what it prints printed again line by line beside the
    card's name and power limit."""
    import io

    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            return fn(*args)
    finally:
        for line in printed.getvalue().splitlines():
            log(f"{phase} ({card}) {label} | {line}")


def _seeded_bn_stats_(torch, module, seed):
    """BatchNorm affine and statistics away from identity, as
    tests/test_backbone_parity.py sets them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)


def _stage_errors(torch, ours: dict, theirs: dict) -> dict:
    """Each stage's largest difference over the reference stage's largest
    |value|, as a share of STAGE_TOL (ours NHWC, theirs NCHW)."""
    return {k: _rel(ours[k].permute(0, 3, 1, 2), theirs[k]) / STAGE_TOL for k in theirs}


def _imported_backbone(torch, tree):
    from object_detection_destr_tpu_torch.models.convert import state_dict_from_flax

    return {"backbone." + k: v.cuda() for k, v in state_dict_from_flax({"params": tree}).items()}


def _checkpoints_equal(torch, paths) -> bool:
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in paths)
    same = a["model"].keys() == b["model"].keys() and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for moment in ("m", "v"):
        same = same and all(torch.equal(a["optimizer"][moment][k], b["optimizer"][moment][k])
                            for k in a["optimizer"][moment])
    return same and a["step"] == b["step"] == 0 and a["loader"] == b["loader"] == {"epoch": 0, "step": 0}


def import_destr(torch, kernels, seed, card, work):
    """(a) DESTR from a torchvision ResNet-50: import from .npz and .pth,
    backbone parity on the card, then 2 resumed steps of the recipe."""
    import numpy as np

    from object_detection_destr_tpu_torch.config import DestrConfig
    from object_detection_destr_tpu_torch.models import import_weights
    from object_detection_destr_tpu_torch.models.convert import resnet_params_from_torch
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train import train as train_cli
    from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference

    ref_models = repo_module("ref_torch_models", os.path.join("tools", "ref_torch_models.py"))
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    resnet = ref_models.TorchResNet((3, 4, 6, 3)).eval()
    _seeded_bn_stats_(torch, resnet, seed)
    sd = resnet.state_dict()
    np.savez(os.path.join(work, "resnet50.npz"), **{k: v.numpy() for k, v in sd.items()})
    torch.save(sd, os.path.join(work, "resnet50.pth"))
    paths = [_beside_card(card, "import_weights", import_weights.main,
                          ["--weights", os.path.join(work, f"resnet50.{ext}"), "--checkpoint_dir",
                           os.path.join(work, f"destr_{ext}")]) for ext in ("npz", "pth")]
    imported = _imported_backbone(torch, resnet_params_from_torch({k: v.numpy() for k, v in sd.items()}))
    restored = restore_for_inference(os.path.join(work, "destr_npz"), "pretrained")
    if not _checkpoints_equal(torch, paths) or not all(torch.equal(restored[k].cuda(), v)
                                                        for k, v in imported.items()):
        raise AssertionError("the .npz and .pth imports differ, or the checkpoint's backbone is not the importer's")
    import_s = time.perf_counter() - t0

    model = build_destr(DestrConfig(), "cuda")
    model.load_state_dict(restored)
    images = torch.randn((2, 640, 640, 3), generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        errors = _stage_errors(torch, model.backbone(images), resnet.cuda()(images.permute(0, 3, 1, 2).contiguous()))
    del model, resnet
    if max(errors.values()) > 1.0:
        raise AssertionError(f"backbone stages against TorchResNet, error / limit {errors}")
    log(f"import ({card}): torchvision ResNet-50 (seeded, BN statistics randomized) written as .npz and .pth, "
        f"import_weights at full width from each in {import_s:.1f} s: checkpoints equal, backbone bit-equal to "
        f"resnet_params_from_torch; backbone on 2 images 640x640 float32 (TF32 off) against TorchResNet, error / "
        f"limit ({STAGE_TOL:g} of each stage's largest value) "
        + " ".join(f"{k}={v:.3f}" for k, v in errors.items()))

    argv = TRAIN_ARGS + ["--seed", str(seed), "--num_train_samples", str(TRAIN_B * IMPORT_STEPS),
                         "--num_valid_samples", "0", "--log_dir", "", "--checkpoint_dir",
                         os.path.join(work, "destr_npz"), "--resume", "--resume_from", "pretrained"]
    reset_counts(kernels)  # the pretrained training path starts here
    result = _beside_card(card, "train.main", train_cli.main, argv)
    torch.cuda.synchronize()
    counts = [k.launches for k in kernels]  # read just after it
    state = result["state"]
    want = [n * IMPORT_STEPS for n in (18, 18, 0, 0, 1, 0, 0, 0, 0)]
    if state.step != IMPORT_STEPS or counts != want:
        raise AssertionError(f"{state.step} resumed steps launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}, not {want}")
    metrics = result["metrics"]
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite or missing losses: {metrics}")
    after = state.model.state_dict()
    moved = {k for k, v in imported.items() if not torch.equal(after[k], v)}
    trains = {k for k in imported if k.split(".")[1].startswith(("layer2", "layer3", "layer4"))
              and "conv" in k.split(".")[2]}
    if moved != trains:
        raise AssertionError(f"moved but frozen: {sorted(moved - trains)[:4]}; held but trainable: "
                             f"{sorted(trains - moved)[:4]}")
    step_ms = result["step_ms"]
    log(f"import ({card}): train.main --resume --resume_from pretrained, {IMPORT_STEPS} steps of the production "
        f"recipe: launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} ({'/'.join(str(c // IMPORT_STEPS) for c in counts)} "
        f"a step); losses " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        + f"; the stem, layer1 and every FrozenBN tensor held, all {len(trains)} layer2-4 conv weights moved; "
        f"step ms (CUDA events, eager) {', '.join(f'{t:.2f}' for t in step_ms)}")
    del state, result
    torch.cuda.empty_cache()
    return {"launches": counts, "stage_error_over_limit": errors, "step_ms": step_ms}


def import_ssd(torch, kernels, seed, card, work):
    """(b) SSD from a torchvision VGG-16: import, conv4_3 parity on the
    card, then 2 resumed steps of the SSD recipe, the trunk held."""
    from object_detection_destr_tpu_torch.config import SSDConfig
    from object_detection_destr_tpu_torch.models import import_weights
    from object_detection_destr_tpu_torch.models.convert import vgg16_params_from_torch
    from object_detection_destr_tpu_torch.models.ssd import build_ssd
    from object_detection_destr_tpu_torch.train import train_ssd
    from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference

    ref_models = repo_module("ref_torch_models", os.path.join("tools", "ref_torch_models.py"))
    torch.manual_seed(seed)
    vgg = ref_models.torch_vgg16_features().eval()
    sd = vgg.state_dict()
    path = os.path.join(work, "vgg16.pth")
    torch.save(sd, path)
    _beside_card(card, "import_weights", import_weights.main,
                 ["--model", "ssd", "--weights", path, "--checkpoint_dir", os.path.join(work, "ssd")])
    imported = _imported_backbone(torch, vgg16_params_from_torch({k: v.numpy() for k, v in sd.items()}))
    restored = restore_for_inference(os.path.join(work, "ssd"), "pretrained")
    if not all(torch.equal(restored[k].cuda(), v) for k, v in imported.items()):
        raise AssertionError("the SSD checkpoint's trunk is not the importer's")
    model = build_ssd(SSDConfig(), "cuda")
    model.load_state_dict(restored)
    images = torch.randn((2, 3, 300, 300), generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        error = _rel(model.backbone(images), vgg.cuda()(images)) / STAGE_TOL
    del model, vgg
    if error > 1.0:
        raise AssertionError(f"conv4_3 against torch_vgg16_features, error / limit {error}")

    argv = [a for a in SSD_ARGS if a != "--device_cache"] + [
        "--seed", str(seed), "--num_train_samples", str(SSD_B * IMPORT_STEPS), "--log_dir", "",
        "--checkpoint_dir", os.path.join(work, "ssd"), "--resume", "--resume_from", "pretrained"]
    reset_counts(kernels)  # the pretrained SSD path starts here
    result = _beside_card(card, "train_ssd.main", train_ssd.main, argv)
    torch.cuda.synchronize()
    counts = [k.launches for k in kernels]
    state = result["state"]
    if state.step != IMPORT_STEPS or counts != list(NO_LAUNCHES):
        raise AssertionError(f"{state.step} resumed SSD steps, launches {counts}")
    metrics = result["metrics"]
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite or missing SSD losses: {metrics}")
    after = state.model.state_dict()
    held = all(torch.equal(after[k], v) for k, v in imported.items())
    if not held:
        raise AssertionError("the VGG trunk moved: the JAX package trains it frozen")
    log(f"import ({card}): torch_vgg16_features (seeded) as .pth, import_weights --model ssd; conv4_3 on 2 images "
        f"300x300 float32 against it, error / limit ({STAGE_TOL:g} of its largest value) {error:.3f}; "
        f"train_ssd.main --resume, {IMPORT_STEPS} steps: losses "
        + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        + f", launches of the nine {counts}, all {len(imported)} trunk tensors bit-equal to the import")
    del state, result
    torch.cuda.empty_cache()
    return {"conv4_3_error_over_limit": error}


def _same_answer(a: dict, b: dict) -> float:
    """The largest box or score difference of two answers with the same
    labels and counts (inf otherwise)."""
    if a["labels"] != b["labels"] or len(a["scores"]) != len(b["scores"]):
        return math.inf
    diffs = [abs(x - y) for x, y in zip(a["scores"], b["scores"])]
    diffs += [abs(x - y) for p, q in zip(a["boxes"], b["boxes"]) for x, y in zip(p, q)]
    return max(diffs, default=0.0)


def serve_reference(torch, kernels, seed, card, work):
    """(c) a reference-layout DESTR and SSD state dict through the
    importers, the .npz and build_service; 4 requests each against the
    source model's own predict."""
    import types

    from object_detection_destr_tpu_torch.config import DestrConfig, SSDConfig
    from object_detection_destr_tpu_torch.infer.server import build_service, get_parser
    from object_detection_destr_tpu_torch.models.convert import (
        destr_variables_from_torch,
        flax_variables_from_state_dict,
        save_variables_npz,
        ssd_variables_from_torch,
    )
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.models.ssd import build_ssd

    layout = repo_module("reference_layout", os.path.join("tests", "reference_layout.py"))
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for kind, sizes in (("destr", REQUEST_SIZES), ("ssd", SSD_REQUEST_SIZES)):
        if kind == "destr":
            source = build_destr(DestrConfig(), "cuda")
            randomize_(torch, source, seed)
            variables = flax_variables_from_state_dict(source)
            imported = destr_variables_from_torch(layout.reference_destr_state_dict(variables))
        else:
            source = build_ssd(SSDConfig(), "cuda")
            randomize_(torch, source, seed + 1)
            variables = flax_variables_from_state_dict(source)
            imported = ssd_variables_from_torch(layout.reference_ssd_state_dict(variables, num_cls=20), num_cls=20)
        name = f"ref_{kind}.npz"
        save_variables_npz(imported, os.path.join(work, name))
        args = get_parser().parse_args(["--model", kind, "--checkpoint_dir", work, "--weights", name,
                                        "--score_thresh", "0.0"])
        reset_counts(kernels)  # the serving path starts here
        service = _beside_card(card, "build_service", build_service, args)
        same = service.model.state_dict()
        if not all(torch.equal(v, same[k]) for k, v in source.state_dict().items()):
            raise AssertionError(f"{kind}: the served weights are not the source model's")
        stand_in = types.SimpleNamespace(model=source.eval(), image_size=service.image_size, device=service.device,
                                         score_thresh=service.score_thresh, _anchors=service._anchors)
        images = [torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8).numpy() for h, w in sizes]
        served = [service.predict_image(image) for image in images]
        counts = [k.launches for k in kernels]  # read just after the serving path
        own = [(eager_predict_image if kind == "destr" else eager_predict_ssd)(torch, stand_in, image)
               for image in images]
        worst = max(_same_answer(a, b) for a, b in zip(served, own))
        exact = served == own

        def requests(scope):
            for i, image in enumerate(images):
                with scope(i):
                    service.predict_image(image)
        window = traced(torch, f"import_serve_{kind}", len(images), requests)
        want_built = [2 * 3 * BLOCKS if (kind, i) == ("destr", 0) else 0 for i in range(9)]
        want_trace = [3.0 * BLOCKS if kind == "destr" else 0.0, 0, 0, 0, 0, 0]
        if worst > SERVE_TOL or counts != want_built or window["per_step"] != want_trace:
            raise AssertionError(f"{kind}: served against the source model {worst} (limit {SERVE_TOL}); launches "
                                 f"{counts}, not {want_built}; a traced request {window['per_step']} (launch lead "
                                 f"{window['launch_lead_s']} s)")
        log(f"import ({card}): reference-layout {kind} state dict "
            f"({sum(v.numel() for v in source.state_dict().values()) / 1e6:.1f} M values) -> {kind}_variables_from_torch "
            f"-> save_variables_npz -> build_service --weights {name}: weights bit-equal to the source; "
            f"{len(images)} requests {'bit-equal to' if exact else f'within {worst:.2e} of'} the source model's own "
            f"predict; launches #1/#2/#3/#4/#9/#8/#5/#6/#7 building the service {counts}, a traced request's "
            f"#1/#2/#3/#4/#9/#8 {window['per_step']}, device busy {window['step_busy_ms']:.3f} ms a request")
        out[kind] = {"launches": counts, "per_request": window["per_step"], "exact": exact, "worst": worst}
        del service, source
        torch.cuda.empty_cache()
    return out


def profile_captured_step(torch, kernels, card):
    """(d) tools/profile_step_torch.py in this process: the captured DESTR
    step (B=16, 640 px, bf16) by kernel."""
    tool = repo_module("profile_step_torch", os.path.join("tools", "profile_step_torch.py"))
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build", "traces", "profile_step")
    shutil.rmtree(trace_dir, ignore_errors=True)
    reset_counts(kernels)  # the profiled path starts here: a warm-up step, the capture, 3 replays
    out = _beside_card(card, "profile", tool.main, ["--steps", str(PROFILE_STEPS), "--batch", str(TRAIN_B), "--image",
                                                    "640", "--top", "10", "--trace_dir", trace_dir])
    counts = [k.launches for k in kernels]
    per_step = [c / PROFILE_STEPS for c in trace_launches(out["trace"]["launches"])]
    busy, total = out["busy_ms_per_step"], out["total_ms_per_step"]
    by_cat = {r["name"]: r["count_per_step"] for r in out["categories"]}
    named = [by_cat.get(n, 0.0) for n in ("flash_attention_fwd #1/#5", "flash_attention_bwd #2", "fused_auction #9")]
    if (per_step != [18.0, 18.0, 0.0, 0.0, 1.0, 0.0] or named != [18.0, 18.0, 1.0]
            or counts[:5] != [36, 36, 0, 0, 2] or not busy <= total <= (1 + PROFILE_OVERLAP) * busy):
        raise AssertionError(f"profile: a step's #1/#2/#3/#4/#9/#8 {per_step} (by category {named}), wrapper "
                             f"launches {counts}, kernels {total} ms a step against busy {busy} (launch lead "
                             f"{out['trace']['launch_lead_s']} s)")
    log(f"import ({card}): profile_step_torch --steps {PROFILE_STEPS} --batch {TRAIN_B} --image 640: a captured step's "
        f"kernels, copies and memsets sum to {total:.2f} ms against {busy:.2f} ms busy "
        f"({(total / busy - 1) * 100:.2f} % above, limit {PROFILE_OVERLAP * 100:.0f} %); median step busy "
        f"{out['step_busy_ms']:.2f} ms of a {out['step_period_ms']:.2f} ms period; #1/#2/#9 a step {named}; "
        f"wrapper launches (warm-up and capture) {counts}")
    return {**{k: out[k] for k in ("step_busy_ms", "step_period_ms", "busy_ms_per_step", "total_ms_per_step",
                                   "categories", "top")}, "per_step": per_step, "launches": counts}


def phase_import(torch, kernels, seed, card):
    """Phase 15, starting from torch weights: (a) DESTR from a torchvision
    ResNet-50, (b) SSD from VGG-16, (c) reference checkpoints served, (d)
    the captured step profiled by kernel."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_import_",
                            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build"))
    try:
        out = {"destr": import_destr(torch, kernels, seed, card, work),
               "ssd": import_ssd(torch, kernels, seed, card, work),
               "serve": serve_reference(torch, kernels, seed, card, work),
               "profile": profile_captured_step(torch, kernels, card)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"import ({card}): phase {out['seconds']:.1f} s")
    return out


DP_EAGER_RUNS = 3  # no-mesh eager samples a 1-rank-mesh replay is held against
DP_STEPS = 2  # steps held so, and the 2-rank run's steps
# 2 gloo ranks against one process, float32 with TF32 off: JAX's tolerances for
# its sharded step against one device (tests/test_parallel.py: metrics and the
# BatchNorm mean rtol 2e-4, updated heads 2e-3), Adam's first moment as a norm
DP_TOL = {"losses": 2e-4, "m": 2e-3, "bn": 2e-4}
# 2 bfloat16 gloo ranks against the float32 process: the change of Adam's
# first moment no farther than this times one bfloat16 process's (bfloat16's
# own distance from float32)
DP_BF16_FACTOR = 2.0
# runs of the 2 bfloat16 ranks so held: a rank whose backward all-reduces
# came in another order than its partner's failed about one run in four
DP_BF16_REPEATS = 3


def _close_group(group) -> None:
    """End an explicit process group (no default group is involved)."""
    for name in ("shutdown", "abort"):
        if hasattr(group, name):
            getattr(group, name)()
            return


def _dp_sample(torch, state, metrics):
    return {"losses": [float(v) for v in metrics.values()],
            "m": torch.cat([m.reshape(-1) for m in state.optimizer._m.values()]),
            "params": _flat_params(torch, state.model)}


def dp_one_rank(torch, kernels, setup, mesh_core, per_step, label, exact=False):
    """Phase 16 (a): a recipe's step over an explicit 1-rank NCCL mesh
    (``mesh_core(mesh)``: its step core over the mesh; the model's
    BatchNorms synced), captured by the epoch runner, against the no-mesh
    step. The no-mesh runner takes step 0 and the mesh runner step 1 (each
    its warm-up and capture); at each of the next DP_STEPS steps, from one
    cloned state, DP_EAGER_RUNS eager no-mesh steps and one replay of the
    mesh graph, which is held to the eager samples' spread (Adam's first
    moment and the parameters relative to the step's change, and the
    losses; ``exact``: cuDNN held to deterministic engines, where the eager
    samples are bit-equal and so must the replay be). Then captured step
    times of both in turns (CUDA events, 3 steps each), and a traced window
    of 3 mesh replays: the launches a step of #1/#2/#3/#4/#9/#8 and the
    device time of the NCCL all-reduce kernels."""
    import torch.distributed as tdist

    from object_detection_destr_tpu_torch.models.destr.mini_detector import sync_batch_norms
    from object_detection_destr_tpu_torch.parallel.mesh import Mesh, group_from_store
    from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner

    state, cache, transform = setup["state"], setup["cache"], setup["transform"]
    _, idx = cache.epoch_index_matrix()
    rows = torch.from_numpy(idx).cuda()
    rows_from = lambda step, n: idx[[i % len(idx) for i in range(step, step + n)]]
    group = group_from_store(tdist.HashStore(), 0, 1, "nccl")
    runners = {}
    try:
        mesh = Mesh(group, 0, 1, torch.device("cuda", torch.cuda.current_device()), "nccl")
        with _cudnn_deterministic(torch, exact):
            reset_counts(kernels)
            runners["no mesh"] = EpochRunner(state, setup["step_core"], transform, cache.data, setup["aug_seed"],
                                             len(cache))
            runners["no mesh"].run(rows_from(0, 1), 0)
            sync_batch_norms(state.model, "data", mesh)
            runners["mesh"] = EpochRunner(state, mesh_core(mesh), transform, cache.data, setup["aug_seed"],
                                          len(cache), mesh=mesh)
            runners["mesh"].run(rows_from(1, 1), 1)
            sync_batch_norms(state.model, None, None)  # the eager steps below are the no-mesh step's
            capture_counts = [k.launches for k in kernels]
            if any(r.graph is None for r in runners.values()) or state.step != 2:
                raise AssertionError(f"data parallel {label}: no graph captured, or {state.step} steps")
            gen, spread = torch.Generator(device="cuda"), {}
            for step in range(2, 2 + DP_STEPS):
                snapshot = [t.detach().clone() for t in _state_tensors(state)]
                start = _dp_sample(torch, state, {})
                eager = []
                for _ in range(DP_EAGER_RUNS):
                    _restore(torch, state, snapshot, step)
                    gen.manual_seed(setup["aug_seed"](step))
                    metrics = setup["train_step"](state, transform(cache.gather(rows[step % len(rows)]), gen))
                    eager.append(_dp_sample(torch, state, metrics))
                _restore(torch, state, snapshot, step)
                got = runners["mesh"].run(rows_from(step, 1), step)
                replay = _dp_sample(torch, state, {k: v[0] for k, v in got.items()})
                state.step = step + 1
                del snapshot
                for key in ("m", "params"):  # relative to the step's change, as phase 6a
                    change = _mean_sample([e[key] for e in eager]).to(start[key].device) - start[key].double()
                    norm = float(change.norm()) or 1.0
                    for smp in (*eager, replay):
                        smp[key] = ((smp[key].double() - start[key].double()) / norm).float()
                spread[f"step {step}"] = _hold_to_spread(f"data parallel {label}, 1-rank mesh replay at step "
                                                         f"{step}", eager, replay)
                del eager, replay, start
            times = {"no mesh": [], "mesh": []}
            for kind in ("no mesh", "mesh", "mesh", "no mesh"):
                events = [torch.cuda.Event(enable_timing=True)]
                torch.cuda.synchronize()
                events[0].record()

                def mark():
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                runners[kind].run(rows_from(state.step, 3), state.step, after_step=mark)
                torch.cuda.synchronize()
                times[kind] += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            windows = {kind: traced(torch, f"dp_{label.replace(' ', '_')}_{kind.replace(' ', '_')}", 3,
                                    lambda scope, kind=kind: runners[kind].run(rows_from(state.step, 3), state.step,
                                                                               step_scope=scope))
                       for kind in ("no mesh", "mesh")}
            window = windows["mesh"]
    finally:
        runners.clear()
        torch.cuda.synchronize()
        _close_group(group)
    if window["per_step"] != [float(n) for n in per_step]:
        raise AssertionError(f"data parallel {label}: a traced 1-rank-mesh replay launched #1/#2/#3/#4/#9/#8 "
                             f"{window['per_step']} times a step, not {list(per_step)}")
    nccl = {k: v for k, v in window["device_time"].items() if "nccl" in k.lower()}
    nccl_ms = sum(v["seconds"] for v in nccl.values()) * 1e3 / 3
    nccl_launches = sum(v["count"] for v in nccl.values()) / 3  # a 1-rank communicator may launch none
    # where the mesh step's device time goes: each kernel's ms and launches a
    # step in the mesh window minus the no-mesh window, the largest first
    zero = {"seconds": 0.0, "count": 0}
    diff = {name: ((windows["mesh"]["device_time"].get(name, zero)["seconds"]
                    - windows["no mesh"]["device_time"].get(name, zero)["seconds"]) * 1e3 / 3,
                   (windows["mesh"]["device_time"].get(name, zero)["count"]
                    - windows["no mesh"]["device_time"].get(name, zero)["count"]) / 3)
            for name in set(windows["mesh"]["device_time"]) | set(windows["no mesh"]["device_time"])}
    by_kernel = [[name[:120], ms, n] for name, (ms, n) in sorted(diff.items(), key=lambda kv: -abs(kv[1][0]))[:10]]
    kernel_sum = [sum(ms for ms, _ in diff.values()), sum(n for _, n in diff.values())]
    out = {"captured_ms": statistics.median(times["mesh"]), "no_mesh_captured_ms": statistics.median(times["no mesh"]),
           "captured_ms_all": times["mesh"], "no_mesh_captured_ms_all": times["no mesh"],
           "nccl_ms_per_step": nccl_ms, "nccl_launches_per_step": nccl_launches, "nccl_kernels": sorted(nccl),
           "per_step": window["per_step"], "idle_share": window["idle_share"],
           "step_busy_ms": window["step_busy_ms"], "step_period_ms": window["step_period_ms"],
           "no_mesh_step_busy_ms": windows["no mesh"]["step_busy_ms"],
           "no_mesh_step_period_ms": windows["no mesh"]["step_period_ms"],
           "no_mesh_idle_share": windows["no mesh"]["idle_share"], "capture_counts": capture_counts, "spread": spread,
           "mesh_minus_no_mesh_by_kernel": by_kernel, "mesh_minus_no_mesh_kernels": kernel_sum}
    log(f"data parallel {label}, explicit 1-rank NCCL mesh, captured by EpochRunner{' (cuDNN deterministic engines)' if exact else ''}: "
        f"replay against {DP_EAGER_RUNS} no-mesh eager steps from one cloned state at steps 2-{1 + DP_STEPS} "
        f"{json.dumps(_rounded(spread))}; captured step ms (CUDA events, in turns N M M N, 3 each) mesh "
        f"{out['captured_ms']:.2f} ({', '.join(f'{t:.2f}' for t in times['mesh'])}), no mesh "
        f"{out['no_mesh_captured_ms']:.2f} ({', '.join(f'{t:.2f}' for t in times['no mesh'])}); traced mesh "
        f"replays: NCCL kernels {out['nccl_kernels']} {nccl_launches:.1f} a step, {nccl_ms:.4f} device ms a step; "
        f"device busy {out['step_busy_ms']:.2f} ms of a {out['step_period_ms']:.2f} ms step, idle share "
        f"{out['idle_share']:.4f} (no mesh: busy {out['no_mesh_step_busy_ms']:.2f} of "
        f"{out['no_mesh_step_period_ms']:.2f}, idle share {out['no_mesh_idle_share']:.4f}); launches a step "
        f"#1/#2/#3/#4/#9/#8 {window['per_step']}; wrapper calls of the warm-ups and captures {capture_counts}; "
        f"mesh minus no mesh, device ms and launches a step: all kernels {kernel_sum[0]:.3f} ms, "
        f"{kernel_sum[1]:.1f}; the largest {json.dumps(_rounded(by_kernel))}")
    return out


def dp_two_gloo_ranks(torch, kernels, seed):
    """Phase 16 (b): two gloo thread-ranks on the one card, each on a CUDA
    stream of its own, eager: the DESTR recipe at full width, dropout 0,
    global B=16 (8 a rank), DP_STEPS steps, against one process on the same
    weights and batches, in float32 (TF32 off) and in bfloat16. Every run's
    step i starts from the float32 process's state before its step i, so
    each comparison is of one step: the discrete choices (top-k, matching)
    of later steps do not flip on parameters that float32 noise has moved.
    In each dtype the ranks' parameters, losses and BatchNorm statistics
    must be bit-identical. Float32 against the float32 process: the losses
    within DP_TOL["losses"] relative, the step's change of Adam's first
    moment within DP_TOL["m"] of its norm, the BatchNorm statistics within
    DP_TOL["bn"] of each one's largest value, the parameters within 2 x
    lr_max (+1e-6). Bfloat16 rounds otherwise at a batch of 8 than of 16,
    so its two ranks are held to its noise floor, in DP_BF16_REPEATS runs:
    their change of the moment no farther from the float32 process's than
    DP_BF16_FACTOR times one bfloat16 process's (the losses, a few scalars
    of that noise, are printed). Each rank's launches of #1/#2/#9 are read off the wrappers'
    counts by stream."""
    import copy
    import dataclasses

    import torch.distributed as tdist

    from object_detection_destr_tpu_torch.models.destr.mini_detector import sync_batch_norms
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.parallel.mesh import Mesh, group_from_store, shard_batch
    from object_detection_destr_tpu_torch.train.state import create_destr_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_train_step

    config = recipe_config(["--seed", str(seed), "--compute_dtype", "float32"])
    cfg = config.train
    batches = [{k: v for k, v in train_batch(torch, TRAIN_B, seed + i).items() if k != "pixel_valid"}
               for i in range(DP_STEPS)]
    torch.manual_seed(seed)
    template = build_destr(dataclasses.replace(config.destr, dropout=0.0), "cuda")

    def model_in(dtype):
        model = copy.deepcopy(template)
        model.config = dataclasses.replace(model.config, compute_dtype=dtype)
        return model

    def bn_stats(model):
        return {k: v.detach().clone() for k, v in model.named_buffers() if k.endswith(("running_mean", "running_var"))}

    def flat_m(state):
        return torch.cat([m.reshape(-1) for m in state.optimizer._m.values()])

    def sample(state, metrics, m_before):
        out = _dp_sample(torch, state, metrics)
        out["m"] = out["m"] - m_before  # the step's change of the moment
        return out

    # the float32 process, and its state before each step
    f32_state = create_destr_state(model_in("float32"), cfg)
    step = make_destr_train_step(cfg)
    starts, f32_one = [], {"samples": []}
    for b in batches:
        starts.append([t.detach().clone() for t in _state_tensors(f32_state)])
        m_before = flat_m(f32_state)
        f32_one["samples"].append(sample(f32_state, step(f32_state, b), m_before))
    f32_one["bn"] = bn_stats(f32_state.model)

    def one_process(dtype):
        state = create_destr_state(model_in(dtype), cfg)
        samples = []
        for i, b in enumerate(batches):
            _restore(torch, state, starts[i], i)
            m_before = flat_m(state)
            samples.append(sample(state, step(state, b), m_before))
        torch.cuda.synchronize()
        return {"samples": samples}

    def two_ranks(dtype):
        copies = [model_in(dtype) for _ in range(2)]
        store = tdist.PrefixStore(f"dp_two_gloo_ranks_{dtype}", tdist.HashStore())
        results, errors = [None, None], [None, None]
        for k in kernels:
            k.launches_by_stream.clear()
        torch.cuda.synchronize()

        def rank_main(r):
            group = None
            try:
                group = group_from_store(store, r, 2, "gloo")
                mesh = Mesh(group, r, 2, torch.device("cuda", torch.cuda.current_device()), "gloo")
                model = sync_batch_norms(copies[r], "data", mesh)
                stream = torch.cuda.Stream()
                with torch.cuda.stream(stream):
                    state = create_destr_state(model, cfg)
                    rank_step = make_destr_train_step(cfg, mesh)
                    samples = []
                    for i, b in enumerate(batches):
                        _restore(torch, state, starts[i], i)
                        m_before = flat_m(state)
                        samples.append(sample(state, rank_step(state, shard_batch(b, mesh)), m_before))
                    stream.synchronize()
                results[r] = {"samples": samples, "bn": bn_stats(model), "stream": stream.cuda_stream}
            except BaseException as e:  # noqa: BLE001 — handed to the phase, which raises it
                errors[r] = e
            finally:
                if group is not None:
                    _close_group(group)

        threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"data parallel, 2 gloo ranks, {dtype}: a rank did not finish in 300 s")
        for e in errors:
            if e is not None:
                raise e
        r0, r1 = results
        for a, b in zip(r0["samples"], r1["samples"]):
            if not torch.equal(a["params"], b["params"]) or a["losses"] != b["losses"]:
                raise AssertionError(f"data parallel, 2 gloo ranks, {dtype}: the ranks' parameters or losses differ")
        if any(not torch.equal(v, r1["bn"][k]) for k, v in r0["bn"].items()):
            raise AssertionError(f"data parallel, 2 gloo ranks, {dtype}: the ranks' BatchNorm statistics differ")
        per_rank = [[k.launches_by_stream.get(res["stream"], 0) for k in kernels[:5]] for res in results]
        want = [n * DP_STEPS for n in (18, 18, 0, 0, 1)]
        if any(p != want for p in per_rank):
            raise AssertionError(f"data parallel, 2 gloo ranks, {dtype}: launches #1/#2/#3/#4/#9 by rank "
                                 f"{per_rank}, not {want}")
        return r0, per_rank

    def apart(mine, ref):
        """Two runs apart at each step: the losses' largest relative
        difference, the change of Adam's first moment relative to its norm."""
        return [{"losses": max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(x["losses"], y["losses"])),
                 "m": float((x["m"] - y["m"]).norm() / y["m"].norm().clamp_min(1e-30))}
                for x, y in zip(mine["samples"], ref["samples"])]

    t0 = time.perf_counter()
    f32_ranks, per_rank = two_ranks("float32")
    bf16_one = one_process("bfloat16")
    bf16_runs = [two_ranks("bfloat16") for _ in range(DP_BF16_REPEATS)]
    (bf16_ranks, bf16_per_rank), seconds = bf16_runs[0], time.perf_counter() - t0

    lr_max = max(cfg.lr, cfg.lr_backbone)
    dist_out = apart(f32_ranks, f32_one)
    for i, (d, mine, ref) in enumerate(zip(dist_out, f32_ranks["samples"], f32_one["samples"])):
        d["params"] = float((mine["params"] - ref["params"]).abs().max())
        if d["losses"] > DP_TOL["losses"] or d["m"] > DP_TOL["m"] or d["params"] > 2 * lr_max + 1e-6:
            raise AssertionError(f"data parallel, 2 gloo ranks against one process at step {i}: {d}")
    bn = max(float((f32_ranks["bn"][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
             for k, v in f32_one["bn"].items())
    if bn > DP_TOL["bn"]:
        raise AssertionError(f"data parallel, 2 gloo ranks: BatchNorm statistics {bn} from one process's")
    bf16 = {"one_process_to_f32": apart(bf16_one, f32_one),
            "ranks_to_f32": [apart(ranks, f32_one) for ranks, _ in bf16_runs],
            "ranks_to_one_process": apart(bf16_ranks, bf16_one)}
    for k, run in enumerate(bf16["ranks_to_f32"]):
        for i, (floor, ranks) in enumerate(zip(bf16["one_process_to_f32"], run)):
            if ranks["m"] > DP_BF16_FACTOR * floor["m"]:
                raise AssertionError(f"data parallel, 2 bfloat16 gloo ranks, run {k}, step {i}: Adam's first "
                                     f"moment {ranks['m']} from the float32 process's, over {DP_BF16_FACTOR} x "
                                     f"one bfloat16 process's {floor['m']}")
    out = {"seconds": seconds, "against_one_process": dist_out, "bn_rel": bn, "launches_per_rank": per_rank,
           "bf16": bf16, "bf16_launches_per_rank": bf16_per_rank}
    log(f"data parallel, 2 gloo thread-ranks on one card (eager, global B={TRAIN_B}, dropout 0, {DP_STEPS} steps "
        f"each from the float32 process's state, float32 and bfloat16, {seconds:.1f} s): parameters, losses and "
        f"BatchNorm statistics bit-identical across ranks in both; float32 against one process: "
        f"{json.dumps(_rounded(dist_out))}, BatchNorm statistics {bn:.3e} of their largest (limits {DP_TOL}); "
        f"bfloat16 (losses, the moment's change) one process to the float32 process "
        f"{json.dumps(_rounded(bf16['one_process_to_f32']))}, the 2 ranks to it in {DP_BF16_REPEATS} runs "
        f"{json.dumps(_rounded(bf16['ranks_to_f32']))} (the moment's limit {DP_BF16_FACTOR} x the former), the "
        f"2 ranks to the bfloat16 process {json.dumps(_rounded(bf16['ranks_to_one_process']))}; launches "
        f"#1/#2/#3/#4/#9 by rank float32 {per_rank}, bfloat16 {bf16_per_rank}")
    del template, starts, f32_state
    return out


def phase_data_parallel(torch, kernels, seed, card):
    """Phase 16, data parallelism on the one card: (a) the DESTR and SSD
    recipes over an explicit 1-rank NCCL mesh, captured, against the no-mesh
    step; (b) two gloo thread-ranks against one process."""
    from object_detection_destr_tpu_torch.train.steps import make_destr_step_core, make_ssd_step_core

    t0 = time.perf_counter()
    setup = destr_capture_setup(torch, seed, [])
    cfg = setup["config"].train
    destr = dp_one_rank(torch, kernels, setup, lambda mesh: make_destr_step_core(cfg, mesh),
                        (18, 18, 0, 0, 1, 0), "DESTR hidden 256")
    del setup
    torch.cuda.empty_cache()
    setup = ssd_capture_setup(torch, seed)
    config = setup["config"]
    ssd = dp_one_rank(torch, kernels, setup, lambda mesh: make_ssd_step_core(config.train, config.ssd, mesh),
                      (0, 0, 0, 0, 0, 0), "SSD300", exact=True)
    del setup
    torch.cuda.empty_cache()
    two = dp_two_gloo_ranks(torch, kernels, seed)
    torch.cuda.empty_cache()
    out = {"destr": destr, "ssd": ssd, "two_ranks": two, "seconds": time.perf_counter() - t0}
    log(f"data parallel ({card}): phase {out['seconds']:.1f} s; multi-GPU throughput not measured (one card)")
    return out


NOISE_ORDERS, NOISE_BOOTSTRAP = 2, 200  # phase 17 (a): val_noise's valid-loader orders and resamples
PM_STEPS = 2  # phase 17 (b): the epoch's steps, each resume's and the replay's
# resumes the replay is held against: with 2, a replay within twice their gap
# failed 19 % of draws from 10 measured runs of the second step (PERF.md), with
# 4 and the nearest resume 0.2 %
PM_RESUMES = 4
PM_KEYS = {"loss": "loss", "loss_model": "loss_model", "loss_det": "loss_det", "loss_class": "m_class",
           "loss_ciou": "m_ciou"}  # the trainer's logged metric -> the post-mortem row's key
LOADER_IMAGES = 256  # phase 17 (d): the JPEG corpus


def _train_log(path) -> dict:
    """{step: the train metrics logged at it} of a metrics.jsonl."""
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return {r["step"]: r for r in records if r.get("prefix") == "train"}


def tools_val_noise(torch, kernels, ckpt, card):
    """(a) tools/val_noise_torch.py on phase 6b's best checkpoint."""
    tool = repo_module("val_noise_torch", os.path.join("tools", "val_noise_torch.py"))
    argv = TRAIN_ARGS + ["--num_valid_samples", str(VALID_SAMPLES), "--checkpoint_dir", ckpt, "--resume_from",
                         "smoke", "--log_dir", "", "--orders", str(NOISE_ORDERS), "--bootstrap", str(NOISE_BOOTSTRAP)]
    reset_counts(kernels)  # the tool's sweeps start here
    t0 = time.perf_counter()
    out = _beside_card(card, "val_noise", tool.main, argv, phase="tools")
    seconds = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    batches = NOISE_ORDERS * (VALID_SAMPLES // TRAIN_B)
    want = [18 * batches, 0, 0, 0, batches, 0, 0, 0, 0]
    if not (out["order_invariant"] and out["per_image_rows_reproduce_sweep"]) or counts != want \
            or out["n_images"] != VALID_SAMPLES:
        raise AssertionError(f"val_noise: {out}; launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}, not {want}")
    log(f"tools ({card}): val_noise on smoke, {VALID_SAMPLES} images x {NOISE_ORDERS} orders in {seconds:.1f} s: "
        f"order_invariant {out['order_invariant']}, per_image_rows_reproduce_sweep "
        f"{out['per_image_rows_reproduce_sweep']}, launches {counts} (18 #1 and 1 #9 a batch, {batches} batches)")
    return {**out, "launches": counts, "seconds": seconds}


def tools_postmortem(torch, kernels, seed, card, work):
    """(b) the trainer runs an epoch of PM_STEPS steps to ``pm_last`` and
    resumes from it PM_RESUMES times for PM_STEPS more, logging every step;
    tools/postmortem_divergence_torch.py replays those steps from
    ``pm_last``. The restored step is deterministic on the card: the
    replay's first step's losses equal every resume's (to the log's
    rounding, 1e-6). Later steps are not: kernel #2 adds dQ with atomics,
    and the next forward's discrete choices (top-k, pairs, matches) amplify
    the difference (0.4 % of the loss between resumes, with deterministic
    cuDNN too; PERF.md). So the replay's gap to the nearest resume,
    over all steps and losses, must stay within twice the largest gap
    between two resumes plus 1e-6. 18 / 18 / 1 launches of #1 / #2 / #9 a
    replayed step."""
    from object_detection_destr_tpu_torch.train import train as train_cli

    tool = repo_module("postmortem_divergence_torch", os.path.join("tools", "postmortem_divergence_torch.py"))
    base = TRAIN_ARGS + ["--seed", str(seed), "--num_train_samples", str(PM_STEPS * TRAIN_B), "--num_valid_samples",
                         "0", "--checkpoint_dir", work]
    train_cli.main(base + ["--save_as", "pm", "--log_dir", ""])
    torch.cuda.empty_cache()
    logs = []
    for r in range(PM_RESUMES):
        run_dir = os.path.join(work, f"resume{r}")
        train_cli.main(base + ["--save_as", f"resume{r}", "--resume", "--resume_from", "pm_last", "--log_dir", run_dir])
        os.remove(os.path.join(work, f"resume{r}_last"))
        log_ = _train_log(os.path.join(run_dir, "metrics.jsonl"))
        logs.append([[log_[s][k] for k in PM_KEYS] for s in sorted(log_)])
        torch.cuda.empty_cache()
    reset_counts(kernels)  # the replay starts here
    t0 = time.perf_counter()
    out = _beside_card(card, "postmortem", tool.main, base + ["--resume", "--resume_from", "pm_last", "--log_dir",
                                                              "", "--steps", str(PM_STEPS), "--out",
                                                              os.path.join(work, "postmortem.jsonl")], phase="tools")
    seconds = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    rows = out["rows"]
    steps = [row["step"] for row in rows]
    if steps != [PM_STEPS + i for i in range(PM_STEPS)] or any(len(log_) != PM_STEPS for log_ in logs):
        raise AssertionError(f"postmortem: replayed steps {steps}, the trainer logged {[len(g) for g in logs]} steps")
    # the replay's values rounded as the trainer's log rounds them (train/logging_utils.py)
    replay = [[round(row[key], 6) for key in PM_KEYS.values()] for row in rows]
    gap = lambda a, b, upto=PM_STEPS: max(abs(x - y) for ra, rb in zip(a[:upto], b[:upto]) for x, y in zip(ra, rb))
    first_gap = max(gap(replay, log_, 1) for log_ in logs)
    replay_gap = min(gap(replay, log_) for log_ in logs)
    resume_gap = max(gap(a, b) for a in logs for b in logs)
    want = [18 * PM_STEPS, 18 * PM_STEPS, 0, 0, PM_STEPS, 0, 0, 0, 0]
    if (first_gap > 1e-6 or replay_gap > 2 * resume_gap + 1e-6 or counts != want
            or out["first_nonfinite_step"] is not None):
        raise AssertionError(f"postmortem: the replay's first step {first_gap} from the resumes' (limit 1e-6), its "
                             f"losses {replay_gap} from the nearest resume, the resumes up to {resume_gap} apart "
                             f"(limit twice that + 1e-6); launches {counts}, not {want}; first non-finite step "
                             f"{out['first_nonfinite_step']}")
    keep = ("loss", "grad_norm", "update_norm", "g_backbone", "u_backbone", "min_gt_area", "min_pred_area")
    log(f"tools ({card}): postmortem replayed steps {steps} from pm_last in {seconds:.1f} s: its first step's losses "
        f"{first_gap:.1e} from every resume's, its losses {replay_gap:.3e} from the nearest of {PM_RESUMES} resumes, "
        f"which are up to {resume_gap:.3e} apart; loss by step, resumes "
        + ", ".join("/".join(f"{r[0]:.6f}" for r in log_) for log_ in logs)
        + f", replay {'/'.join(f'{r[0]:.6f}' for r in replay)}; launches {counts} (18 / 18 / 1 a step); rows "
        + "; ".join(" ".join(f"{k}={row[k]:.6g}" for k in ("step",) + keep) for row in rows))
    return {"first_gap": first_gap, "replay_gap": replay_gap, "resume_gap": resume_gap, "launches": counts,
            "per_step": [c / PM_STEPS for c in counts], "seconds": seconds,
            "rows": [{k: row[k] for k in ("step",) + keep} for row in rows]}


def phase_tools(torch, kernels, seed, card, ckpt):
    """Phase 17, the JAX side's tools on the port: (a) val_noise on phase
    6b's checkpoint, (b) the post-mortem replay against the trainer's own
    resumes, (c) probe_flash at its defaults, (d) bench_loader on a written
    JPEG corpus, (e) the convolution roofline beside phase 15 (d)'s trace."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_",
                            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build"))
    try:
        out = {"val_noise": tools_val_noise(torch, kernels, ckpt, card)}
        torch.cuda.empty_cache()
        out["postmortem"] = tools_postmortem(torch, kernels, seed, card, work)
        torch.cuda.empty_cache()
        probe = repo_module("probe_flash_torch", os.path.join("tools", "probe_flash_torch.py"))
        out["probe_flash"] = _beside_card(card, "probe_flash", probe.main, [], phase="tools")
        loader = repo_module("bench_loader_torch", os.path.join("tools", "bench_loader_torch.py"))
        corpus = os.path.join(work, "corpus")
        loader.build_synthetic_coco(corpus, LOADER_IMAGES, (600, 800))
        out["bench_loader"] = _beside_card(card, "bench_loader", loader.main, ["--root", corpus], phase="tools")
        roofline = repo_module("roofline_conv_torch", os.path.join("tools", "roofline_conv_torch.py"))
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build", "traces", "profile_step")
        out["roofline"] = _beside_card(card, "roofline", roofline.main, ["--batch", str(TRAIN_B), "--image", "640",
                                                                          "--profile", trace_dir], phase="tools")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    probe, roof = out["probe_flash"], out["roofline"]
    if not (math.isfinite(probe["fwd_ms"]) and math.isfinite(probe["fwd_bwd_ms"]) and roof["measured_conv_ms"] > 0
            and out["bench_loader"]["value"] > 0):
        raise AssertionError(f"tools: probe_flash {probe}, roofline {roof}, bench_loader {out['bench_loader']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"tools ({card}): probe_flash Sq=Sk={probe['sq']} B={probe['b']}: #1 {probe['fwd_ms']:.4f} ms (bound "
        f"{probe['fwd_bound_ms']:.4f}, SDPA {probe['sdpa_fwd_ms']:.4f}), #1 + {probe['backward_plan']} backward "
        f"{probe['fwd_bwd_ms']:.4f} ms (bound {probe['fwd_bwd_bound_ms']:.4f}, SDPA {probe['sdpa_fwd_bwd_ms']:.4f}); "
        f"bench_loader {out['bench_loader']['value']} images/s ({out['bench_loader']['path']}); roofline at B={TRAIN_B}: "
        f"convolutions' bound {roof['conv_only_bound_ms']:.3f} ms ({roof['bound_ms']:.3f} with the residual adds) "
        f"against {roof['measured_conv_ms']:.3f} ms traced in phase 15 (d); phase {out['seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    try:
        from object_detection_destr_tpu_torch.ops.cuda import auction
        from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script: {exc}", file=sys.stderr)
        return 1
    # the kernels in the order of their counts: #1, #2, #3, #4, #9, #8, #5, #6, #7
    kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
               auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
               fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]

    t_start = time.perf_counter()
    phase_seconds, last = {}, [t_start]
    val_ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")  # phase 6b's checkpoints, read again in phase 17

    def clock(name):
        """The seconds since the previous clock, added to ``name``'s."""
        now = time.perf_counter()
        phase_seconds[name] = phase_seconds.get(name, 0.0) + now - last[0]
        last[0] = now

    try:
        card = phase_device(torch)
        one_bf16 = one_bf16_backward(fa)
        phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY, auction.LIBRARY, one_bf16.library])
        clock("device and build")
        phase_plan(torch, fa)
        warm_clocks(torch)
        flash_rows = phase_flash(torch, args.seed)
        shares = phase_dropout_share(torch, args.seed, flash_rows)
        seed_checks = phase_seed_replay(torch, args.seed)
        split_rows = phase_split(torch, args.seed, one_bf16)
        unpacked_rows = phase_unpacked(torch, args.seed)
        api_counts = phase_unpacked_api(torch, kernels, args.seed)
        auction_rows, l2 = phase_auction(torch, args.seed)
        assign_rows, assign_counts = phase_assignment(torch, kernels, args.seed, l2)
        clock("kernels (3-5)")
        runs = {}
        for label, extra, per_step_launches in (("hidden 256", [], (18, 18, 0, 0, 1, 0, 0, 0, 0)),
                                                ("hidden 512", WIDE_ARGS, (18, 12, 6, 6, 1, 0, 0, 0, 0))):
            state, counts, step_ms = phase_train(torch, kernels, args.seed, extra, per_step_launches, label)
            parts = step_parts(torch, state, train_batch(torch, TRAIN_B, args.seed), recipe_train_config(extra))
            log(f"train {label}: where a step of make_destr_train_step goes, ms (CUDA events, median of 3) "
                + " ".join(f"{k}={v:.2f}" for k, v in parts.items())
                + f" rest={parts['step'] - sum(v for k, v in parts.items() if k != 'step'):.2f}")
            runs[label] = (counts, step_ms)
            del state
            torch.cuda.empty_cache()
            clock("train (6)")
        captured = {}
        for label, extra, per_step_launches in (("hidden 256", [], (18, 18, 0, 0, 1, 0)),
                                                ("hidden 512", WIDE_ARGS, (18, 12, 6, 6, 1, 0))):
            captured[label] = phase_captured_train(torch, kernels, destr_capture_setup(torch, args.seed, extra),
                                                   per_step_launches, label)
        clock("captured train (6a)")
        val_counts, val_timing = phase_validation(torch, kernels, args.seed, val_ckpt)
        clock("validation (6b)")
        torch.cuda.empty_cache()
        scan = phase_train_scan(torch, args.seed)
        clock("epoch scan (6c)")
        torch.cuda.empty_cache()
        for destr in (None, {"hidden_dim": 512}):
            phase_train_compare(torch, kernels, args.seed, destr)
            torch.cuda.empty_cache()
            clock("train compare (7)")
        gen = torch.Generator().manual_seed(args.seed)
        images = [torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8).numpy()
                  for h, w in REQUEST_SIZES]
        service, variables, serve_launches, serve_timing, forward_ms = phase_serving(
            torch, fa.flash_attention_fwd, args.seed, images
        )
        phase_whole_model(torch, service, variables, images)
        clock("serving (8-9)")
        ssd_images = [torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8).numpy()
                      for h, w in SSD_REQUEST_SIZES]
        ssd_service, ssd_serve = phase_ssd_serving(torch, kernels, args.seed, ssd_images)
        cli_worst = phase_cli(torch, {"destr": (service, images), "ssd": (ssd_service, ssd_images)})
        clock("ssd serving, cli (10-11)")
        del service, ssd_service, variables
        torch.cuda.empty_cache()
        ssd_train = phase_ssd_train(torch, kernels, args.seed)
        ssd_val = phase_ssd_validation(torch, kernels, args.seed)
        clock("ssd train, validation (12-13)")
        torch.cuda.empty_cache()
        real = phase_real_data(torch, kernels, args.seed)
        clock("real data (14)")
        torch.cuda.empty_cache()
        imported = phase_import(torch, kernels, args.seed, card)
        clock("import (15)")
        torch.cuda.empty_cache()
        dp = phase_data_parallel(torch, kernels, args.seed, card)
        clock("data parallel (16)")
        torch.cuda.empty_cache()
        tools = phase_tools(torch, kernels, args.seed, card, val_ckpt)
        clock("tools (17)")
    except Exception:  # noqa: BLE001 — report the failing phase and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(val_ckpt, ignore_errors=True)

    def step_rows(sites):
        """A training step's cells: B=16, bfloat16, dropout 0.3, masked as
        on the path, backward by the plan (6 launches at each site)."""
        return [r for r in flash_rows for (n, *_, m) in sites
                if r["site"] == n and r["b"] == TRAIN_B and r["dtype"] == "bfloat16" and r["rate"] == RATE
                and r.get("bwd_plan") in ("fused", "two_pass")]

    path, wide = step_rows(PATH_SITES), step_rows(WIDE_SITES)
    wide_fused, wide_cross = wide[:2], wide[2:]
    # the same step cells on the device alone (CUDA-graph replay), dropout 0 and 0.3
    share_path = [r for r in shares if r["site"] in {s[0] for s in PATH_SITES}]
    share_wide = [r for r in shares if r["site"] in {s[0] for s in WIDE_SITES}]

    def device_rates(rows, kind):
        rows = [r for r in rows if f"{kind}_ms_0.0" in r]
        return {f"device_ms_rate_{rate}": per_step(rows, f"{kind}_ms_{rate}") for rate in (0.0, RATE)}
    # a request: the same sites at B=1, float32, no dropout, masked as served
    serve = [r for r in flash_rows for (n, *_, m) in PATH_SITES
             if r["site"] == n and r["b"] == 1 and r["dtype"] == "float32" and r["masked"] == m]
    log("serving float32 B=1, #1 on the tensor cores (3xTF32), device ms a launch (CUDA graph): "
        + "; ".join(f"{r['site']} {r['ms']:.4f} (SDPA {r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
                    f"{r['bound_ms']:.4f}, rel_err {r['rel_err']:.2e}; CUDA-core kernel's recorded time "
                    f"{CUDA_CORE_RECORDED_MS['fwd_f32_b1'][r['site']]:.4f}, not this run)" for r in serve)
        + f"; a request's 18 launches {BLOCKS * sum(r['ms'] for r in serve):.4f} against SDPA's "
        f"{BLOCKS * sum(r['library_ms'] for r in serve):.4f}")
    counts, step_ms = runs["hidden 256"]
    wide_counts, wide_step_ms = runs["hidden 512"]

    def per_step(rows, key):
        return BLOCKS * sum(r[key] for r in rows)

    def bound_by(rows, key):
        return "operations" if all(r[key] == "operations" for r in rows) else "bytes"

    def abs_err(rows, kind, names=("dq", "dk", "dv")):
        return max(r["bwd_abs_err"][f"{kind} {n}"] for r in rows for n in names)

    def timed(rows, kind):
        """ms, plain_ms, bound_ms, bound_by of a step's launches of one kernel."""
        return {"ms": per_step(rows, f"{kind}_ms"), "plain_ms": per_step(rows, f"{kind}_plain_ms"),
                "bound_ms": per_step(rows, f"{kind}_bound_ms"), "bound_by": bound_by(rows, f"{kind}_bound_by")}

    synthetic = auction_rows[0]
    sdpa = "library_ms is SDPA forward + backward (dQ, dK and dV together)"

    def two_pass_rel_err(names):
        """#3's or #4's gradient errors relative to the plain version's
        largest value at both cross sites (B=16, bfloat16), by site and rate."""
        return {f"{r['site']} rate {r['rate']}": {n: r["bwd_rel_err"][f"two_pass {n}"] for n in names}
                for r in flash_rows if r["site"] in (WIDE_CROSS[0], PATH_SITES[2][0]) and r["b"] == TRAIN_B
                and r["dtype"] == "bfloat16" and "two_pass dq" in r.get("bwd_rel_err", {})}
    log("bf16 #3 / #4 errors relative to the plain version's largest value: "
        + "; ".join(f"{k} " + " ".join(f"{n}={e:.2e}" for n, e in v.items())
                    for k, v in two_pass_rel_err(("dq", "dk", "dv")).items()))

    def unpacked_rows_of(rows, sites):
        names = [site[0] for site in sites]
        return [r for r in rows if r["site"] in names and r["b"] == TRAIN_B and r["dtype"] == "bfloat16"
                and r["rate"] == RATE]

    def sums(rows, prefix):
        """ms, plain_ms, bound_ms, bound_by of one launch at each row's shape."""
        return {"ms": sum(r[prefix + "ms"] for r in rows), "plain_ms": sum(r[prefix + "plain_ms"] for r in rows),
                "bound_ms": sum(r[prefix + "bound_ms"] for r in rows), "bound_by": bound_by(rows, prefix + "bound_by")}
    entries = [
        {
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_fwd.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:592",
            "launches": counts[0],
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "ms": per_step(path, "ms"), "plain_ms": per_step(path, "plain_ms"),
            "bound_ms": per_step(path, "bound_ms"), "bound_by": bound_by(path, "bound_by"),
            "library_ms": per_step(path, "library_ms"), **device_rates(share_path, "fwd"),
            "per": f"train step: 18 launches (3 call sites x 6 blocks), B={TRAIN_B}, bfloat16 (tensor cores), "
                   f"dropout {RATE}, eager calls; device_ms_rate_* the same launches from CUDA-graph replay",
            "hidden_512": {"launches": wide_counts[0], "max_abs_err": max(r["max_abs_err"] for r in wide),
                           "ms": per_step(wide, "ms"), "plain_ms": per_step(wide, "plain_ms"),
                           "bound_ms": per_step(wide, "bound_ms"), "library_ms": per_step(wide, "library_ms"),
                           **device_rates(share_wide, "fwd")},
            "validation": {"launches": val_counts[0], "per": "4 train steps and 4 validation batches, 18 each"},
            "captured_step": {label: {k: v for k, v in c.items() if k != "spread"} for label, c in captured.items()},
            "seed_replay": seed_checks,
            "real_data": {"launches": real["cli"]["eager"]["launches"][0],
                          "remat_launches_a_micro_step": real["remat"]["launches"]["remat"][0],
                          "remat_captured_per_step": real["remat"]["captured"]["captured_per_step"][0],
                          "per": "train.main on a WIDER FACE tree, --letterbox --grad_accum_steps 2: 4 mini-steps "
                                 "(18 each) and 1 validation batch (18); with DestrConfig(remat=True) 36 a "
                                 "micro-step (forward and recomputation), eager and replayed"},
            "import": {"launches": imported["destr"]["launches"][0],
                       "serving_launches": imported["serve"]["destr"]["launches"][0],
                       "serving_per_request": imported["serve"]["destr"]["per_request"][0],
                       "profile_per_step": imported["profile"]["per_step"][0],
                       "per": f"train.main --resume --resume_from pretrained after import_weights: {IMPORT_STEPS} "
                              "steps (18 each); a reference checkpoint served: the service's warm-up and capture "
                              "(18 each), a request a replay of 18 (trace); profile_step_torch: a replayed step "
                              "(trace)"},
            "serving": {"launches": serve_launches, "ms": per_step(serve, "ms"), **serve_timing,
                        "device_ms": per_step(serve, "ms"),
                        "plain_ms": per_step(serve, "plain_ms"), "library_ms": per_step(serve, "library_ms"),
                        "bound_ms": per_step(serve, "bound_ms"), "bound_by": bound_by(serve, "bound_by"),
                        "max_abs_err": max(r["max_abs_err"] for r in serve),
                        "rel_err": max(r["rel_err"] for r in serve),
                        "sites": {r["site"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "rel_err")}
                                  for r in serve},
                        "per": "request: 18 launches (3 call sites x 6 blocks), B=1, float32 (tensor cores, "
                               "3xTF32), masked as served; ms and device_ms from CUDA-graph replay, library_ms "
                               "SDPA's float32 forward the same way; sites: one launch each; launches: the "
                               "wrapper's calls while the service is built (its warm-up forward and its "
                               "capture), a request being a replay of the captured 18 (counted from the trace); "
                               "captured_ms / eager_ms: request latency (host clock, median of 8), *_idle_share "
                               "and *_step_busy_ms from a torch.profiler trace of 4 requests"},
        },
        {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_bwd.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:884",
            "launches": counts[1],
            "max_abs_err": abs_err(path, "fused"),
            **timed(path, "bwd"), "library_ms": per_step(path, "bwd_library_ms"), **device_rates(share_path, "bwd"),
            "per": f"train step: 18 launches, B={TRAIN_B}, bfloat16 (tensor cores), dropout {RATE}, eager calls; "
                   f"device_ms_rate_* the same launches from CUDA-graph replay; {sdpa}",
            "split_rel_err": {r["site"]: r for r in split_rows},
            "import": {"launches": imported["destr"]["launches"][1], "profile_per_step": imported["profile"]["per_step"][1]},
            "hidden_512": {"launches": wide_counts[1], "max_abs_err": abs_err(wide_fused, "fused"),
                           **timed(wide_fused, "bwd"), "library_ms": per_step(wide_fused, "bwd_library_ms"),
                           **device_rates(share_wide, "bwd"), "per": "12 launches: encoder and decoder self-attention"},
        },
        {
            "name": "flash_attention_dq", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_bwd_two_pass.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:778",
            "launches": wide_counts[2],
            "max_abs_err": abs_err(wide_cross, "two_pass", ("dq",)),
            **timed(wide_cross, "dq"), "library_ms": per_step(wide_cross, "bwd_library_ms"),
            **device_rates(share_wide, "dq"), "rel_err": two_pass_rel_err(("dq",)),
            "per": f"hidden-512 train step: 6 launches at the merged cross-attention (d 1024, dv 512), "
                   f"B={TRAIN_B}, bfloat16 (tensor cores), dropout {RATE}, eager calls; device_ms_rate_* the "
                   f"same launches from CUDA-graph replay; rel_err at both cross sites; {sdpa}",
        },
        {
            "name": "flash_attention_dkv", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_bwd_two_pass.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:826",
            "launches": wide_counts[3],
            "max_abs_err": abs_err(wide_cross, "two_pass", ("dk", "dv")),
            **timed(wide_cross, "dkv"), "library_ms": per_step(wide_cross, "bwd_library_ms"),
            **device_rates(share_wide, "dkv"), "rel_err": two_pass_rel_err(("dk", "dv")),
            "per": f"hidden-512 train step: 6 launches at the merged cross-attention (d 1024, dv 512), "
                   f"B={TRAIN_B}, bfloat16 (tensor cores), dropout {RATE}, eager calls; device_ms_rate_* the "
                   f"same launches from CUDA-graph replay; rel_err at both cross sites; {sdpa}",
        },
        {
            "name": "auction_assignment", "route": "cuda",
            "source": f"{PKG}/csrc/auction.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/auction.py:189",
            "launches": assign_counts[5],
            "max_abs_err": max(r["max_abs_err"] for r in assign_rows),
            "ms": assign_rows[0]["ms"], "kernel_device_ms": assign_rows[0]["kernel_device_ms"],
            "plain_ms": assign_rows[0]["plain_ms"],
            "bound_ms": assign_rows[0]["bound_ms"], "bound_by": assign_rows[0]["bound_by"], "library_ms": None,
            **{k: assign_rows[0][k] for k in ("rounds", "plain_rounds", "bids", "plain_bids")},
            "rows_differing": assign_rows[0]["differ"],
            "per": "one hungarian_match(cost_bbox=2.5) call: 16 problems N=300 T=300, at most 8 valid targets; "
                   "ms around batched_assignment (value matrix + launch), kernel_device_ms the launch alone "
                   "(CUDA graph); max_abs_err is the largest total-cost gap of a near-tie; library_ms null: no "
                   "PyTorch call solves an assignment",
            "others": [{k: r[k] for k in ("setting", "n", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                                          "bound_by", "bids", "plain_bids", "differ")}
                       for r in assign_rows[1:]],
        },
        {
            "name": "fused_auction", "route": "cuda",
            "source": f"{PKG}/csrc/auction.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/auction.py:271",
            "launches": counts[4],
            "max_abs_err": max(r["max_abs_err"] for r in auction_rows),
            "ms": synthetic["ms"], "device_ms": synthetic["device_ms"],
            "kernel_device_ms": synthetic["kernel_device_ms"], "plain_ms": synthetic["plain_ms"],
            "bound_ms": synthetic["bound_ms"], "bound_by": synthetic["bound_by"], "library_ms": None,
            **{k: synthetic[k] for k in ("rounds", "plain_rounds", "bids", "plain_bids")},
            "rows_differing": synthetic["differ"],
            "per": "train step: 1 launch, 32 problems N=400 T=300, at most 8 valid targets; ms the wrapper's "
                   "eager call (its PyTorch prologue included), device_ms the same call from CUDA-graph replay, "
                   "kernel_device_ms the launch alone; library_ms null: no PyTorch call solves an assignment",
            "dense": {k: auction_rows[1][k] for k in ("ms", "device_ms", "kernel_device_ms", "plain_ms", "bound_ms",
                                                      "bound_by", "bids", "plain_bids", "differ")},
            "hidden_512": {"launches": wide_counts[4]},
            "validation": {"launches": val_counts[4], "per": "4 train steps and 4 validation batches"},
            "import": {"launches": imported["destr"]["launches"][4], "profile_per_step": imported["profile"]["per_step"][4]},
        },
    ]
    # the head-major kernels: one launch at each hidden-256 call-site shape
    # (B=16, bfloat16, dropout 0.3), hidden 512 beside; launches from the
    # public API's run (phase 3b)
    api_path, api_wide = unpacked_rows_of(unpacked_rows, PATH_SITES), unpacked_rows_of(unpacked_rows, WIDE_SITES)
    per = "one launch at each of the 3 hidden-256 call-site shapes, (B, h, S, d), B=16, bfloat16, dropout 0.3"
    entries.append({
        "name": "flash_attention_unpacked_fwd", "route": "cuda",
        "source": f"{PKG}/csrc/flash_attention_fwd.cu",
        "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:151",
        "launches": api_counts[6],
        "max_abs_err": max(r["max_abs_err"] for r in unpacked_rows),
        **sums(api_path, ""), "library_ms": sum(r["library_ms"] for r in api_path),
        "per": per + "; library_ms is SDPA forward",
        "hidden_512": {**sums(api_wide, ""), "library_ms": sum(r["library_ms"] for r in api_wide)},
    })
    for index, kind, names, replaces in ((7, "dq", ("dq",), 344), (8, "dkv", ("dk", "dv"), 385)):
        entries.append({
            "name": f"flash_attention_unpacked_{kind}", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_bwd_two_pass.cu",
            "replaces": f"object_detection_destr_tpu/ops/pallas/flash_attention.py:{replaces}",
            "launches": api_counts[index],
            "max_abs_err": max(r["bwd_abs_err"][n] for r in unpacked_rows for n in names),
            **sums(api_path, kind + "_"), "library_ms": sum(r["bwd_library_ms"] for r in api_path),
            "per": per + f"; {sdpa}",
            "hidden_512": {**sums(api_wide, kind + "_"), "library_ms": sum(r["bwd_library_ms"] for r in api_wide)},
        })
    log(f"train step median ms: hidden 256 {step_ms:.2f} ({TRAIN_B / step_ms * 1e3:.1f} images/s), hidden 512 "
        f"{wide_step_ms:.2f} ({TRAIN_B / wide_step_ms * 1e3:.1f} images/s); kernels per step ms "
        + " ".join(f"{e['name']}={e['ms']:.3f}" for e in entries)
        + f"; captured step ms " + ", ".join(f"{k} {c['captured_ms']:.2f} (eager {c['eager_ms']:.2f})"
                                              for k, c in captured.items())
        + f"; train.main --epoch_scan step ms {scan['step_ms']['scan']:.2f}"
        + f"; request latency median ms={serve_timing['captured_ms']:.2f} (eager {serve_timing['eager_ms']:.2f}), "
        f"model forward ms={forward_ms:.2f}; validation "
        f"eval step ms a batch={val_timing['val_batch_ms']:.2f}, {val_timing['val_images_per_sec']:.1f} images/s a "
        f"sweep, EMA update ms={val_timing['ema_update_ms']:.3f}, checkpoint {val_timing['checkpoint_mb']:.1f} MB in "
        f"{val_timing['checkpoint_save_s']:.2f} s; SSD300: captured step ms {ssd_train['captured_ms']:.2f} "
        f"({SSD_B / ssd_train['captured_ms'] * 1e3:.1f} images/s, eager {ssd_train['eager_ms']:.2f}), request "
        f"median ms {ssd_serve['captured_ms']:.2f} (eager {ssd_serve['eager_ms']:.2f}), validation "
        f"{ssd_val['val_images_per_sec']:.1f} images/s, cli max difference {cli_worst}; real data: "
        f"captured mini-step ms {real['captured']['captured_ms']:.2f} (eager {real['captured']['eager_ms']:.2f}), "
        f"remat micro-step ms {real['remat']['remat_ms']:.2f} (without {real['remat']['plain_ms']:.2f}), captured "
        f"remat mini-step ms {real['remat']['captured']['captured_ms']:.2f}, peak GB "
        f"{real['remat']['remat_peak_gb']:.2f} (without {real['remat']['plain_peak_gb']:.2f}), loader images/s "
        f"native {real['pool']['native_images_per_sec']:.1f}, PIL + cv2 {real['pool']['pil_cv2_images_per_sec']:.1f}; "
        f"pretrained: resumed step ms {', '.join(f'{t:.2f}' for t in imported['destr']['step_ms'])}, profiled "
        f"captured step busy ms {imported['profile']['step_busy_ms']:.2f} (kernels {imported['profile']['total_ms_per_step']:.2f}), "
        f"phase {imported['seconds']:.1f} s; data parallel: captured step ms over a 1-rank NCCL mesh DESTR "
        f"{dp['destr']['captured_ms']:.2f} (no mesh {dp['destr']['no_mesh_captured_ms']:.2f}, NCCL "
        f"{dp['destr']['nccl_ms_per_step']:.4f}), SSD {dp['ssd']['captured_ms']:.2f} (no mesh "
        f"{dp['ssd']['no_mesh_captured_ms']:.2f}, cuDNN deterministic), 2 gloo ranks {dp['two_ranks']['seconds']:.1f} s, "
        f"phase {dp['seconds']:.1f} s; tools: val_noise {tools['val_noise']['seconds']:.1f} s, postmortem replay gap "
        f"{tools['postmortem']['replay_gap']:.3e} (resumes {tools['postmortem']['resume_gap']:.3e}), probe_flash "
        f"#1 {tools['probe_flash']['fwd_ms']:.4f} ms, #1 + backward {tools['probe_flash']['fwd_bwd_ms']:.4f} ms, "
        f"loader {tools['bench_loader']['value']} images/s, convolutions {tools['roofline']['measured_conv_ms']:.3f} "
        f"ms against a {tools['roofline']['conv_only_bound_ms']:.3f} ms bound, phase {tools['seconds']:.1f} s; "
        f"total {time.perf_counter() - t_start:.0f} s ({card}); seconds by phase "
        f"{json.dumps(_rounded(phase_seconds))}")
    for entry, index in ((entries[0], 0), (entries[1], 1), (entries[5], 4)):
        entry["data_parallel"] = {
            "launches_per_rank": [rank[index] for rank in dp["two_ranks"]["launches_per_rank"]],
            "one_rank_mesh_per_step": dp["destr"]["per_step"][index],
            "per": f"phase 16: launches_per_rank, each of 2 gloo thread-ranks on the card over {DP_STEPS} eager "
                   f"float32 steps (B=8 a rank, global {TRAIN_B}), counted by the rank's CUDA stream; "
                   "one_rank_mesh_per_step, a replayed step over an explicit 1-rank NCCL mesh (trace)"}
    pm, probe = tools["postmortem"], tools["probe_flash"]
    entries[0]["tools"] = {"val_noise_launches": tools["val_noise"]["launches"][0],
                           "postmortem_per_step": pm["per_step"][0],
                           "probe_flash": {k: probe[k] for k in ("sq", "b", "heads", "rate", "fwd_ms", "fwd_bound_ms",
                                                                 "sdpa_fwd_ms")},
                           "per": "phase 17: val_noise's sweeps (18 a batch), a post-mortem replayed step; "
                                  "probe_flash's device ms of one launch (CUDA graph, best of 3) at Sk = Sq, no mask"}
    entries[1]["tools"] = {"postmortem_per_step": pm["per_step"][1],
                           "probe_flash": {k: probe[k] for k in ("sq", "b", "heads", "rate", "backward_plan",
                                                                 "fwd_bwd_ms", "fwd_bwd_bound_ms", "sdpa_fwd_bwd_ms")},
                           "per": "phase 17: a post-mortem replayed step; probe_flash's #1 + #2 device ms"}
    entries[5]["tools"] = {"val_noise_launches": tools["val_noise"]["launches"][4],
                           "postmortem_per_step": pm["per_step"][4]}
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
