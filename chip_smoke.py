"""Drive the PyTorch port on one NVIDIA GPU: its DESTR training step at
hidden width 256, 512 and 1024, its validation sweep, checkpoints, resume and
evaluator, its head-major flash-attention API, its L1-cost matcher and its
serving path; SSD300's serving, training, validation and the batch CLI;
training on image files with the JAX package's options (letterbox,
gradient accumulation, bfloat16 moments, optimizer layouts, remat);
training and serving from torch weights, and the captured step profiled by
kernel; data-parallel training over explicit process groups; the JAX
package's tools on the port (val noise, the divergence post-mortem, the
flash probe, the loader bench, the convolution roofline); the port's
launchers, scripts/*_torch.sh, as subprocesses; BASELINE.json's config 4
(DESTR-R101 with the dilated C5 at 1333 px) trained, captured, evaluated,
served and profiled; BASELINE.json's config 2 (DESTR-R50 over COCO's 80
classes at 800 px) trained on a COCO-layout tree, evaluated, batch-inferred,
served and its batched bf16 forward timed; BASELINE.json's config 1 (SSD300
over COCO's 80 classes) trained, captured, evaluated, batch-inferred and
served; and validation run as the JAX package runs it (the eval steps captured, both
metrics on the device through the greedy-match kernel); and hold each
hand-written CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):
  1. device: require CUDA, print the card's name and power limit, turn TF32
     off for matmuls and convolutions;
  2. build: compile the four csrc/*.cu files (and the measurement copy of
     #2) with nvcc at once (timed); the fused backward's shared-memory size
     as the library counts it equal to its Python mirror (which plans the
     backward), the forward's and the two-pass kernels' launch plans as the
     libraries export them equal to their Python mirrors at head widths
     16-4096 in both dtypes, every plan within the card's shared memory,
     and the plan of each call site printed;
  3. flash attention, kernels #1-#4 against their plain versions: the
     training step's three call-site shapes at hidden 256 and at hidden 512
     (B=16, float32 and bfloat16, dropout 0 and 0.3, masked as on the path;
     forward, the kernel's own keep mask read off its output, equal to the
     plain Philox mask with a kept share within 0.005 of 0.7; backward by
     the plan's kernels, #2 or the two-pass #3 + #4, with dQ / dK / dV
     errors relative to each tensor's largest value; a fully masked batch
     entry in the float32 cells of every masked site), the
     hidden-256 sites again with the two-pass kernels held against #2 on the
     same inputs, the Sk=7056 shapes at B=1 (backward), and slice 1's forward
     cells plus the wide cross-attention's (device times from CUDA-graph
     replay); times of the kernels, their plain versions and
     F.scaled_dot_product_attention (a yardstick, never on the path), and
     the bound from bytes and operations. #1-#4 run on the tensor cores
     in both dtypes (float32 in 3xTF32): for the step cells of both widths,
     the device times (CUDA-graph replay) of #1 and of #2, or #3 and #4 where
     the plan runs them, at dropout 0 and 0.3 side by side, beside their
     eager times, their plain versions', their bounds, SDPA's and the
     replaced CUDA-core kernels' recorded times (PERF.md; not measured
     here), in bfloat16 and in float32 (its #2 at hidden 256 and at hidden
     512's self-attention, #3 and #4 at hidden 512's and hidden 1024's
     cross-attention); #3's and #4's errors at every cross site; and #2's
     gradient errors with its hi / lo bf16 pairs and with one bf16 for dS
     and P keep (a copy of #2 built for that measurement only, with
     -DODTT_FLASH_BWD_ONE_BF16);
  3d. heads past 1024 (phase_beyond_1024): hidden 1024's sites (encoder
     self 400x400, 8 heads of 128; decoder self 300x300, 8 of 256; cross
     600x400, one head of d 2048, dv 1024), hidden 768's cross (d 1536),
     an odd width (d 1040, dv 520) and hidden 1024's cross at Sk 7056
     (B=1), each in float32 and bfloat16 at dropout 0 and 0.3, packed (#1
     and the plan's backward: #2 at d 128 / 256, the two-pass #3 + #4, wide
     class, past 1024) and head-major (#5-#7, bit-equal to the packed
     launches), against the plain versions; the bf16 dropout-0.3 step cells
     and the float32 dropout-0.3 cross cell (the wide 3xTF32 #3 / #4) timed
     with SDPA (or its refusal) and the bound, the others checked only; the
     float32 two-pass plans of these sites as the library exports them equal
     to the Python mirror's; hidden 1024's float32 B=1 request cells on the
     device;
  3a. the head-major (B, h, S, d) kernels #5 (forward), #6 (dQ) and #7
     (dK / dV) against their plain versions at the call-site shapes of both
     widths (B=16, float32 and bfloat16, dropout 0 and 0.3, masked as on the
     path) and at Sk=7056 (B=1), each bit-equal to #1 / #3 / #4 on the same
     logical inputs in the packed layout; times beside the plain versions,
     SDPA (which takes this layout) and the bound, and float32 #6's and
     #7's device times (CUDA-graph replay) at dropout 0 and 0.3 beside the
     replaced CUDA-core kernels' recorded eager times;
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
     6 / 1 launches a step (the cross-attention's backward is two-pass), and
     with --hidden_dim 1024 at 2 + 2 blocks, 6 / 4 / 2 / 2 / 1 (its d 2048
     cross head takes the wide class); train-640-f32, the recipe with --compute_dtype
     float32 at hidden 256 (every attention backward on the 3xTF32 #2, 18 /
     18 / 0 / 0 / 1 launches a step); and train-640-wide-f32, the recipe
     with --hidden_dim 512 --compute_dtype float32 (#2 at the
     self-attention, the 3xTF32 #3 / #4 at the cross-attention, 18 / 12 / 6
     / 6 / 1 launches a step);
  6a. the captured step at the three widths on device-cached batches: the epoch
     runner takes step 0 (eager warm-up, CUDA-graph capture); at each of
     steps 1-2, from one cloned state, five eager steps (the first once
     under torch.cuda.set_sync_debug_mode("error")), a replay with the
     step's seeds and a replay with the capture's seeds (a planted fault):
     the replay's Adam first moment and parameters (relative to the step's
     change) and its 2 steps' losses no farther from the eager samples' mean
     than the largest distance between two eager samples, the planted fault
     farther; step times (CUDA events) eager and captured in turns; a
     torch.profiler window of 3 steps of each: the device's busy time and
     idle share, the launches a step read from the trace (18 / 18 / 0 /
     0 / 1, 18 / 12 / 6 / 6 / 1 and at hidden 1024's 2 + 2 blocks 6 / 4 / 2
     / 2 / 1 of #1 / #2 / #3 / #4 / #9) and each
     kernel's device ms a step; peak memory of each; the same for
     train-640-f32 and train-640-wide-f32 with 3 eager samples a step;
  6b. the validation path: train.train.main with the production recipe, a
     32-image validation split, --ema_decay 0.999, --coco_eval and
     checkpoints for 4 steps: exactly 18 / 18 / 0 / 0 / 1 launches of #1 /
     #2 / #3 / #4 / #9 a step and 18 of #1 and 1 of #9 in each of the
     captured eval step's warm-up and capture (the live and EMA sweeps, 2
     batches each, replay one graph), one greedy-match launch a batch and
     metric; smoke, smoke_ema and smoke_last written; infer.evaluate.main on
     smoke reproduces the trainer's mAP within 1e-6 (36 #1 launches: its
     captured forward's warm-up and capture); a resume from smoke_last runs
     steps 5-8; the eval step's time a batch eager and captured, the
     sweep's images/s, the metric updates on the device, the EMA update and
     a checkpoint's size and write time;
  6c. train.train.main with --device_cache --epoch_scan, 2 epochs on 64
     samples, against five --device_cache runs (the per-step path, the
     first with --profile_dir): final parameters and logged losses no
     farther from the per-step runs' mean than two per-step runs are apart,
     the profile's trace parsed (steps 2 and 3, the traced range 2-4 cut by
     the 4-step epoch; 18 / 18 / 0 / 0 / 1 launches a step), the cache's
     bytes and build time;
  7. one whole train step, kernels against plain versions: B=4, float32,
     dropout 0, the same weights and batch, at hidden 256, 512 and 1024; the
     kernel run's discrete choices (pairs, top-k indices, matcher rows) must
     be near-ties where the plain run's differ and are then replayed in it;
     loss, gradients and updated parameters compared;
  8. serving at full width: build_service captures the predict (its
     warm-up and capture call #1's wrapper 18 times each), 8 requests as
     graph replays and the same 8 with the model run eagerly, the
     detections equal; latencies of both; a torch.profiler trace of 4
     requests of each: 18 #1 launches a request, device busy time, idle
     share;
  8a. hidden 1024 (phase_h1024_service): train.main with the recipe and
     --hidden_dim 1024 at 2 + 2 blocks (H1024_BLOCKS), 2 steps and a
     16-image validation batch (6 / 4 / 2 / 2 / 1 launches a step, 6 / 0 /
     0 / 0 / 1 in each of the captured eval step's warm-up and capture,
     COCO AP beside the mAP), its checkpoint; infer.evaluate.main on it
     reproduces the trainer's mAP and COCO AP (1e-6, 12 #1 launches: its
     captured forward's warm-up and capture); build_service
     restores it and serves phase 8's requests, every #1 call float32, the
     cross-attention's at d 2048, dv 1024;
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
     18 / 18 / 1 of #1 / #2 / #9 a mini-step and 18 / 0 / 1 in each of the
     captured eval step's warm-up and capture, moments bfloat16, TensorBoard events; mini-steps 1 and 2 from a
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
     to the sweep's mAP and COCO AP, 18 #1 and 1 #9 launches in each of the
     captured eval step's warm-up and capture (its 4 batches replay); (b)
     the production recipe (hidden 256, B=16, bf16, dropout 0.3) trained an
     epoch of 2 steps to pm_last and resumed from it 10 times for 2 more,
     logging every step; postmortem_divergence replays those 2 steps from
     pm_last: its first step's losses equal to every resume's (1e-6, the
     log's rounding), its losses no farther from the nearest resume's than
     the largest gap between two resumes plus 1e-6 (kernel #2's atomic dQ
     makes no two runs of a later step bit-equal, and the next step's
     discrete choices amplify that), 18 / 18 / 1 launches of #1 /
     #2 / #9 a step; (c) probe_flash at its defaults (Sq = Sk = 7056, B=1, 8 heads
     of 32, dropout 0.1): #1 and #1 + #2 device times against their bound
     and SDPA's; (d) bench_loader on 256 written 600x800 JPEGs (COCO
     layout); (e) roofline_conv at B=16, 640 px against the convolution
     category of phase 15 (d)'s trace.
 18. launchers: scripts/train_prod_synth_torch.sh (640 px, 6+6 blocks,
     top_k 300, B=16, bf16, EMA, COCO AP, --epoch_scan) and
     scripts/train_prod_ssd_torch.sh (300 px, B=32) as subprocesses, each
     cut to one epoch of 2 steps and 32 validation images, with its
     checkpoints and logs in a temporary directory; then infer.evaluate on
     the DESTR checkpoint. Each subprocess runs in its own process group,
     killed past its time limit, under a python first on PATH that counts
     the nine wrappers' launches in that process: exit code 0; the recipes'
     tags in metrics.jsonl (Metric/coco_mAP, Metric/ema_mAP, ...) and train
     records at steps 1 and 2; the best, _ema (DESTR) and _last
     checkpoints; 72 / 36 / 4 launches of #1 / #2 / #9 in DESTR's run (the
     epoch runner's warm-up step and capture, 18 / 18 / 1 each, and the
     sweeps' captured eval step's warm-up and capture, 18 / 0 / 1 each),
     none of the nine in SSD's; the evaluator's one JSON line with map and
     coco_map equal to the trainer's logged values (within 1e-5, its
     printing's rounding) and 36 #1 launches (its captured forward's
     warm-up and capture).
 19. BASELINE.json's config 4, train-1333-r101-dc5: DESTR-R101 with the
     dilated C5 (layer4 at stride 1) at 1333 px, B=1, bf16, on synthetic
     1399 px canvases, so the encoder takes 84 x 84 = 7056 tokens and the
     cross-attention 7056 keys: #1 and #2 at the step's three sites (B=1,
     bf16, dropout 0.3) and #9 on its 2 problems of N = 7056 against their
     plain versions; train.train.main for 4 steps and a 2-image validation
     split (exactly 18 / 18 / 0 / 0 / 1 launches of #1 / #2 / #3 / #4 / #9
     a step and 18 / 0 / 0 / 0 / 1 in each of the captured eval step's
     warm-up and capture, finite losses, the
     updates as the parameter groups say, its best checkpoint written), the
     parts of 3 more steps; the captured step against 3 eager samples a
     step (phase 6a's check, times, traces and peak memory);
     infer.evaluate on the checkpoint (the trainer's mAP; 36 #1, its captured
     forward's warm-up and capture);
     four requests of four aspects at 1333 px in float32 through infer.cli
     (one invocation a request, 18 #1 each) and phase 8's serving on a
     DetectionService built with infer.server.build_model (the server's
     flags have no --dilation, as in the JAX package), the CLI's detections
     within 1e-5 of the service's; tools/profile_step_torch.py at --batch 1
     --image 1333 --backbone resnet101 --dilation: its table by category,
     and #1's and #2's device ms a replayed step at each call site.
 20. BASELINE.json's config 2, coco-800: DESTR-R50 over COCO's 80 classes
     (--num_cls 81, the background channel last) at 800 px, B=8, bf16, on a
     COCO-layout tree written from the seed (COCO's 80 category ids with
     their gaps, JPEGs at COCO's common sizes, 1-20 boxes an image over all
     80 classes, crowd and zero-width annotations the reader skips): #1 at
     the step's three sites (encoder 625 x 625 tokens, decoder 300 x 300,
     cross 600 x 625) in bf16 at B=8 and float32 at B=1 and B=8, #1 and #2
     at B=8, bf16, dropout 0.3, and #9 at C = 81 on a step's 16 problems of
     N = 625, against their plain versions; train.train.main --dataset coco
     for 4 steps and 2 validation batches with COCO AP (18 / 18 / 0 / 0 / 1
     a step); the captured step on the tree's batches against 3 eager
     samples a step; infer.evaluate on its checkpoint (the driver's map and
     coco_map within 1e-6; 36 #1, its captured forward's warm-up and
     capture; one greedy-match launch a batch and metric) and the sweep
     split into host decode and letterbox, the eval transform, the forward
     eager and captured, the metrics' updates on the device and compute,
     and the trainer's sweep again on its graph;
     infer.cli on 8 of the tree's images in one invocation, letterboxed and
     stretched (18 #1 each); phase 8's serving on a captured DetectionService
     at --num_cls 81 --image_size 800, the CLI's letterboxed detections
     held to the service's image by image (labels equal, boxes and scores
     within C2_CLI_TOL; where a near tie makes an image's B=1 forward pick
     other top-k tokens or pairs than the batch, against that image run with
     the batch's choices replayed); the model's forward as bench.py's infer mode runs
     it (B=8, 800 px, bf16, eval, letterbox pixel masks), eager and replayed
     as a CUDA graph: ms a batch, images/s, busy ms, idle share, peak memory.
 21. BASELINE.json's config 1, coco-ssd-300: SSD300 over COCO's 80 classes
     (--num_cls 80) with the SSD trainer's defaults (B=12, 300 px, bf16,
     reference mining, lr 1e-5) on a COCO-layout tree of 48 train and 24 val
     images: train_ssd.main for 4 steps and a validation sweep with its
     checkpoints; the captured step held bit-equal to 3 eager samples a step
     under deterministic cuDNN (phase 12's check; times, traces and peak
     memory with the default engines); infer.evaluate --model ssd on the
     checkpoint (the driver's mAP within 1e-6) and the sweep split into host
     decode and stretch, the eval transform, the eval step eager and
     captured, the 80-class mAP update on the device, and the trainer's
     sweep again on its graph; infer.cli --model ssd --num_cls 80 on 8 of the tree's images
     in one invocation against phase 10's serving on a captured SSD
     DetectionService (the same detections within 1e-5, at a score threshold
     read off the CLI's forward). The nine kernels' counts stay 0.
 22. validation as the JAX package runs it (phase_val_device): (a) the
     greedy-match kernel (csrc/greedy_match.cu, both metrics' walk) against
     its plain version, hits bit-equal, at the path's three launches:
     config 2's COCO records (B=8 x 80 classes, 100 ranks, T=300, 10
     thresholds), config 1's 11-point metric (B=12 x 80, R=300) and DESTR's
     one-class metric (B=16, R=300), on operands with ties, rows at exactly
     0.5, NaN rows and problems without a target; device ms beside the
     plain version's and the bound; (b) both metrics on the card against the
     plain version on CPU copies (states, hits and APs exact, COCO's
     sigmoid scores within 1e-6 relative) on seeded detections at config 2's
     and config 1's shapes and on the eval steps' outputs of (c); (c) the
     trainers' eval steps captured (train/steps.py::CapturedEvalStep)
     against eager for DESTR at config 2's shapes and SSD at config 1's on a
     COCO-layout tree: bit-equal outputs and losses under deterministic
     cuDNN, within the eager spread with the default engines, the trainers'
     sweeps captured and eager equal before and after two train steps, with
     an EMA swapped in and after a checkpoint restore (one graph, which
     reads the live weights), and a traced replayed DESTR batch with both
     metric updates: 18 #1, 1 #9 and 2 greedy-match launches.
 23. the span stamp (csrc/span_stamp.cu, phase_span_stamp) against its
     plain version on the host at a span recorder's shape (32 rows of 64
     columns, 28 stamps a row out of the columns' order), eagerly and from
     one captured graph replayed a row a replay, with slots outside the
     rows: the same cells written and no others, stamps rising along the
     stream, a stamp pair around a spin kernel within 0.02 ms + 0.5 % of
     CUDA events inside it, launches counted from 0 (the earlier phases,
     which run every DESTR path without a recorder, launched none).

The line before the last lists the kernels as JSON (#1-#4 also with
their device times at dropout 0 and 0.3, #2's split errors, #3's and #4's
errors at the cross sites and each kernel's float32 entry; #1's serving
entry with its float32 B=1 sites; #8's and #9's rounds and bids beside the
plain version's; #1's, #2's and #9's config_4 entries, phase 19's, and config_2 entries,
phase 20's; the greedy-match kernel's entry, phase 22's cells and phase 6b's
launches; the span stamp's entry, phase 23's); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
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
# the same call sites with --hidden_dim 1024: the merged cross-attention's
# head is 2048 wide (dv 1024), past the 1024 the kernels once took. Phases
# 6, 6a and 8a train, validate and serve it at H1024_BLOCKS encoder and
# decoder blocks (243 M parameters instead of 436 M), to keep the script
# inside its time limit; the kernel cells (phase 3d) hold its call sites at
# every width
H1024_BLOCKS = 2
H1024_ARGS = ["--hidden_dim", "1024", "--num_encoder_blocks", str(H1024_BLOCKS), "--num_decoder_blocks",
              str(H1024_BLOCKS)]
H1024_SITES = [
    ("encoder_self_h1024", 400, 400, 8, 128, 128, True),
    ("decoder_self_h1024", 300, 300, 8, 256, 256, False),
    ("cross_cls_reg_h1024", 600, 400, 1, 2048, 1024, True),
]
H1024_CROSS = H1024_SITES[2]
# #1 at the three sites, #2 at the two self-attentions, #3 / #4 at the cross, #9 a step
H1024_PER_STEP = (3 * H1024_BLOCKS, 2 * H1024_BLOCKS, H1024_BLOCKS, H1024_BLOCKS, 1, 0, 0, 0, 0)
# beside them: hidden 768's cross-attention, an odd width past 1024, and
# hidden 1024's cross-attention at the dilated configuration's Sk
BEYOND_SITES = [("cross_cls_reg_h768", 600, 400, 1, 1536, 768, True),
                ("cross_odd_1040", 600, 400, 1, 1040, 520, True)]
H1024_LONG = ("cross_cls_reg_h1024_7056", 600, 7056, 1, 2048, 1024, True)
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
# device ms a launch (CUDA graph; B=16, float32, dropout 0.3, masked as on
# the path) of the CUDA-core float32 kernels that the 3xTF32 ones replaced,
# as artifacts/port_f32_bwd_r1/f32_one.py measured them on the tree before
# the 3xTF32 #2 (PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700.00 W): #2
# at its sites, #3 and #4 at the cross-attentions of hidden 512 and 1024; and
# eager ms of one launch of the head-major #6 / #7 at the hidden-256 sites
# (this script on the same card and tree). Printed beside this run's times,
# never measured by this run and never in its kernels line
CUDA_CORE_F32_RECORDED_DEVICE_MS = {
    "bwd": {"encoder_self": 1.711, "decoder_self": 3.300, "cross_cls_reg": 3.403, "encoder_self_wide": 5.444,
            "decoder_self_wide": 6.516},
    "dq": {"cross_cls_reg_wide": 8.817, "cross_cls_reg_h1024": 18.79},
    "dkv": {"cross_cls_reg_wide": 11.95, "cross_cls_reg_h1024": 26.86},
}
CUDA_CORE_F32_RECORDED_UNPACKED_MS = {"dq": {"encoder_self": 1.4806, "decoder_self": 0.7949, "cross_cls_reg": 2.1568},
                                      "dkv": {"encoder_self": 1.2457, "decoder_self": 1.1340, "cross_cls_reg": 5.9123}}
F32_ARGS = ["--compute_dtype", "float32"]
F32_EAGER_RUNS = 3  # the float32 cells' eager samples a captured step is held against
# the steps after the capture that phases 6a and 14 hold to eager samples
# (the other captured cells hold TRAIN_STEPS), to keep the script inside its
# time limit
HELD_STEPS = 2
# BASELINE.json's config 4: ResNet-101 with the dilated C5 at 1333 px, B=1
# (bench.py's BENCH_BACKBONE=resnet101 BENCH_DILATION=1 BENCH_IMAGE=1333
# BENCH_BATCH=1); the recipe's other flags are TRAIN_ARGS'
C4_LABEL = "train-1333-r101-dc5"
C4_IMAGE = 1333
C4_CANVAS = int(C4_IMAGE * 672 / 640)  # 1399, the trainer's canvas
C4_ARGS = ["--backbone", "resnet101", "--dilation", "--image_size", str(C4_IMAGE), "--batch_size", "1",
           "--synthetic_size", str(C4_CANVAS), "--num_train_samples", str(TRAIN_STEPS)]
C4_VALID = 2  # validation images, a batch each
C4_TOKENS = 84 * 84  # C5 at stride 16: 1333 -> 667 -> 334 -> 167 -> 84
C4_REQUEST_SIZES = [(h * C4_IMAGE // 640, w * C4_IMAGE // 640) for h, w in REQUEST_SIZES]  # (H, W)
C4_PER_STEP = (18, 18, 0, 0, 1, 0, 0, 0, 0)  # backward_plan routes by d and dv, not by Sk
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
            args = re.findall(r"L[ib](\d+)E", mangled)  # int and bool template arguments
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
    fused_widths = sorted(set(range(8, 1025, 8)) | {1, 17, 33, 100, 520, 1040})
    for d in fused_widths:
        for dv in fused_widths:
            for itemsize in (4, 2):
                counted = lib.odtt_flash_bwd_smem_bytes(d, dv, itemsize)
                mirrored = fa.fused_backward_smem_bytes(d, dv, itemsize)
                if counted != mirrored:
                    raise AssertionError(f"fused backward at d={d} dv={dv} itemsize={itemsize}: the library counts "
                                         f"{counted} bytes of shared memory, the plan's mirror {mirrored}")
    sites = PATH_SITES + WIDE_SITES + H1024_SITES + BEYOND_SITES
    plans = {name: {str(dt).split(".")[-1]: fa.backward_plan(d, dv, dt, optin) for dt in (torch.float32, torch.bfloat16)}
             for name, _, _, _, d, dv, _ in sites}
    want = {name: "fused" if d <= 512 else "two_pass" for name, _, _, _, d, _, _ in sites}
    if any(set(p.values()) != {want[name]} for name, p in plans.items()):
        raise AssertionError(f"backward plans {plans}, expected {want}")
    # the forward's and the two-pass kernels' launch plans as the libraries
    # dispatch them, against the Python mirrors, at head widths 16-4096
    fwd, two_pass = fa.FWD_LIBRARY.library(), fa.TWO_PASS_LIBRARY.library()
    out = (ctypes.c_longlong * 5)()
    widths = sorted(set(range(16, 4097, 48)) | {32, 64, 128, 256, 512, 520, 768, 1024, 1040, 1536, 1816, 2048, 4096})
    largest = 0
    for d in widths:
        for dv in widths:
            for code, dt in enumerate((torch.float32, torch.bfloat16)):
                if fwd.odtt_flash_fwd_plan(code, d, dv, out) != 0 or tuple(out[:4]) != fa.forward_plan(d, dv, dt):
                    raise AssertionError(f"forward plan at d={d} dv={dv} {dt}: library {tuple(out[:4])}, mirror "
                                         f"{fa.forward_plan(d, dv, dt)}")
                largest = max(largest, out[3])
                for dq in (1, 0):
                    p = fa.two_pass_plan(d, dv, dt, bool(dq))
                    mirror = (fa._TWO_PASS_KERNELS.index(p.kernel), *p[1:])
                    if two_pass.odtt_flash_two_pass_plan(code, dq, d, dv, out) != 0 or tuple(out[:5]) != mirror:
                        raise AssertionError(f"two-pass plan at d={d} dv={dv} {dt} dq={dq}: library {tuple(out[:5])}, "
                                             f"mirror {mirror}")
                    largest = max(largest, out[4])
    if largest > optin:
        raise AssertionError(f"a plan takes {largest} bytes of shared memory, over the card's {optin}")
    site_plans = {name: {str(dt).split(".")[-1]: (fa.forward_plan(d, dv, dt).chunks, fa.two_pass_plan(d, dv, dt, True),
                                                  fa.two_pass_plan(d, dv, dt, False))
                         for dt in (torch.float32, torch.bfloat16)}
                  for name, _, _, _, d, dv, _ in H1024_SITES + BEYOND_SITES}
    log(f"plan: {optin} bytes of shared memory a block (opt-in); the fused backward's layout equals the library's "
        f"count at {len(fused_widths) ** 2} width pairs (1-1040) x 2 dtypes; backward by call site {plans}; the "
        f"forward and two-pass launch plans equal the "
        f"libraries' at {len(widths) ** 2} width pairs (16-4096) x 2 dtypes, the largest {largest} bytes; past 1024 "
        f"(forward dv chunks, dq plan, dkv plan): {site_plans}")


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


def _ms_or_note(row, key):
    """A row's ``key``_ms printed, or the reason it has none."""
    return f"{row[key + '_ms']:.4f}" if row[key + "_ms"] is not None else f"none ({row[key + '_note']})"


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


def sdpa_ms(torch, timer, fn):
    """``timer``'s ms of one SDPA call, or (None, the reason SDPA gave)."""
    try:
        return timer(torch, fn), None
    except (torch.cuda.OutOfMemoryError, RuntimeError) as exc:
        torch.cuda.empty_cache()
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"


def flash_cell(torch, gen, site, b, dtype, rate, masked, backward, graph_timing, fully_masked_entry=False,
               timed=True):
    """One shape cell of kernel #1 against its plain version and, with
    ``backward``, of the backward the plan picks for the card ("plan"),
    kernel #2 ("fused"), kernels #3 + #4 ("two_pass"), or both, then also
    held against each other ("both"). The plain forward runs one batch
    entry at a time where its (B, h, Sq, Sk) scores would pass 2 GiB (no
    dropout there). ``fully_masked_entry`` masks every key of batch entry 0.
    ``timed`` False checks the cell without timing it."""
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
    row["bound_ms"], row["bound_by"] = bound_ms(b, sq, sk, h, d, dv, q.element_size(), masked, dname)
    if timed:
        row["ms"] = timer(torch, lambda: fa.flash_attention_fwd(q, k, v, h, mask, None, rate, seed))
        if graph_timing:
            time_cuda(torch, plain, reps=1)  # warm the allocator outside the graph
        row["plain_ms"] = timer(torch, plain)
        row["library_ms"], row["library_note"] = sdpa_ms(torch, timer, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias, dropout_p=rate))

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
        pairs = {"bwd": (fa.flash_attention_bwd, fa.flash_attention_packed_backward_reference),
                 "dq": (fa.flash_attention_dq, fa.flash_attention_dq_reference),
                 "dkv": (fa.flash_attention_dkv, fa.flash_attention_dkv_reference)}
        kinds = {"fused": ["bwd"], "two_pass": ["dq", "dkv"], "both": ["bwd", "dq", "dkv"]}[plan]
        for kind in kinds:
            kernel, reference = pairs[kind]
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms(b, sq, sk, h, d, dv, itemsize, masked,
                                                                       dname, kind)
            if timed:
                row[f"{kind}_ms"] = time_cuda(torch, lambda: kernel(*args))
                row[f"{kind}_plain_ms"] = time_cuda(torch, lambda: reference(*args))
        if timed:
            row["bwd_library_ms"], row["bwd_library_note"] = sdpa_ms(torch, time_cuda, library_fwd_bwd)
    row["ok"] = ok
    msg = (f"flash {name:23s} B={b:<2d} {dname:8s} rate={rate} masked={int(masked)}"
           + (" (entry 0 fully masked)" if fully_masked_entry else "")
           + f" fwd rel_err={row['rel_err']:.2e} lse_err={row['lse_err']:.2e}")
    if timed:
        msg += (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={_ms_or_note(row, 'library')} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                + (" (device, CUDA graph)" if graph_timing else " (eager calls)"))
    if rate:
        msg += f" kernel kept={row['kept']:.5f} equal to the plain mask={row['keep_equal']}"
    if backward:
        msg += (f" | bwd {row['bwd_plan']} rel_err " + " ".join(f"{n}={e:.2e}" for n, e in row["bwd_rel_err"].items()))
        if "two_pass_vs_fused" in row:
            msg += " two-pass vs #2 " + " ".join(f"{n}={e:.2e}" for n, e in row["two_pass_vs_fused"].items())
        if timed:
            for kind in kinds:
                msg += (f" {kind}_ms={row[f'{kind}_ms']:.4f} plain_ms={row[f'{kind}_plain_ms']:.4f} "
                        f"bound_ms={row[f'{kind}_bound_ms']:.4f} ({row[f'{kind}_bound_by']})")
            msg += f" sdpa_fwd_bwd_ms={_ms_or_note(row, 'bwd_library')}"
    log(msg + ("" if timed else " (checked, not timed)") + (" OK" if ok else " FAIL"))
    torch.cuda.empty_cache()
    return row


def phase_flash(torch, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for sites in (PATH_SITES, WIDE_SITES):  # the training step's cells at hidden 256 and 512
        for site in sites:
            for dtype in (torch.float32, torch.bfloat16):
                for rate in (0.0, RATE):
                    full = dtype is torch.float32 and site[-1]
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


def phase_beyond_1024(torch, seed):
    """Kernels #1, #3, #4 and #5, #6, #7 past head width 1024 (d 1536, 2048
    and 1040; Sk 400 and 7056) and at hidden 1024's self-attention widths:
    each site in float32 and bfloat16, at dropout 0 and 0.3, packed (#1 and
    the plan's backward, #2 or #3 + #4) and head-major (#5-#7, bit-equal to
    the packed launches), against the plain versions; B=16, Sk 7056 at B=1;
    a fully masked batch entry in the float32 dropout-0 cell of hidden
    1024's cross-attention. Timed (eager calls): the training step's
    bfloat16 dropout-0.3 cells of the hidden-1024 sites, the float32
    dropout-0.3 cell of its cross-attention (the wide 3xTF32 #3 / #4) and
    the head-major cross cell; the rest is checked only. Each site's float32
    two-pass plans as the library exports them equal to the Python mirror's.
    Then a hidden-1024 request's float32 B=1 forward cells (device time).
    Returns (packed rows, head-major rows)."""
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    lib, out = fa.TWO_PASS_LIBRARY.library(), (ctypes.c_longlong * 5)()
    f32_plans = {}
    for name, _, _, _, d, dv, _ in H1024_SITES + BEYOND_SITES:
        for dq in (1, 0):
            p = fa.two_pass_plan(d, dv, torch.float32, bool(dq))
            mirror = (fa._TWO_PASS_KERNELS.index(p.kernel), *p[1:])
            if lib.odtt_flash_two_pass_plan(0, dq, d, dv, out) != 0 or tuple(out[:5]) != mirror:
                raise AssertionError(f"float32 two-pass plan at {name} dq={dq}: library {tuple(out[:5])}, "
                                     f"mirror {mirror}")
            f32_plans[f"{name} {'dq' if dq else 'dkv'}"] = p
    log(f"float32 two-pass plans past 1024 (the library's, equal to the mirror's): {f32_plans}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    rows, unpacked = [], []
    for site in H1024_SITES + BEYOND_SITES + [H1024_LONG]:
        b = 1 if site is H1024_LONG else TRAIN_B
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, RATE):
                step_cell = rate == RATE and (site in H1024_SITES and dtype is torch.bfloat16 or site is H1024_CROSS)
                full = site is H1024_CROSS and dtype is torch.float32 and not rate
                rows.append(flash_cell(torch, gen, site, b, dtype, rate, site[-1], "plan", False, full,
                                       timed=step_cell))
                unpacked.append(unpacked_cell(torch, gen, site, b, dtype, rate,
                                              timed=step_cell and site is H1024_CROSS and dtype is torch.bfloat16))
    for site in H1024_SITES:  # a hidden-1024 request's launches
        rows.append(flash_cell(torch, gen, site, 1, torch.float32, 0.0, site[-1], None, True))
    failed = [r for r in rows + unpacked if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} flash-attention cells past 1024 out of tolerance: {failed[:2]}")
    return rows, unpacked


def phase_dropout_share(torch, seed, flash_rows, dtype=None, sites=None):
    """The step cells of the path sites (B=16, masked as on the path; by
    default bfloat16 at hidden 256, 512 and 1024): #1, and #2 or #3 and #4
    as the plan runs them, on the device alone (CUDA-graph replay of the
    wrappers' calls; #2's with its delta, dQ zeroing and cast, #3's and
    #4's with their delta) at dropout 0 and 0.3 side by side, so the Philox
    draws' share shows. Printed beside each kernel's eager time, its plain
    version's, its bound and SDPA's from phase 3, and the CUDA-core kernels'
    recorded times. Ms a launch by site."""
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa

    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    rows = []
    for name, sq, sk, h, d, dv, masked in sites or PATH_SITES + WIDE_SITES + H1024_SITES:
        q, k, v, dout = (torch.randn(TRAIN_B, s, h * w, generator=gen, device="cuda").to(dtype)
                         for s, w in ((sq, d), (sk, d), (sk, dv), (sq, dv)))
        mask = None
        if masked:
            lengths = torch.randint(sk * 3 // 4, sk + 1, (TRAIN_B,), generator=gen, device="cuda")
            mask = torch.arange(sk, device="cuda")[None, :] < lengths[:, None]
        row = {"site": name, "dtype": dname, "fused": fa.backward_plan(d, dv, dtype, optin) == "fused"}
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
        eager = next(r for r in flash_rows if r["site"] == name and r["b"] == TRAIN_B and r["dtype"] == dname
                     and r["rate"] == RATE and r.get("bwd_plan") in ("fused", "two_pass"))
        def recorded(kind):
            if dtype is torch.float32:
                ms = CUDA_CORE_F32_RECORDED_DEVICE_MS.get(kind, {}).get(name)
                return "" if ms is None else f"; CUDA-core kernel's recorded device time {ms:.4f}, not this run"
            ms = CUDA_CORE_RECORDED_MS[kind].get(name)
            return "" if ms is None else f"; CUDA-core kernel's recorded eager time {ms:.4f}, not this run"
        msg = (f"{dname} {name:19s} #1 device ms rate 0 / {RATE}: {row['fwd_ms_0.0']:.4f} / "
               f"{row[f'fwd_ms_{RATE}']:.4f} (eager {eager['ms']:.4f}, SDPA eager {_ms_or_note(eager, 'library')}"
               f"{recorded('fwd')})")
        for kind, label in (("bwd", "#2"),) if row["fused"] else (("dq", "#3"), ("dkv", "#4")):
            msg += (f"; {label} device ms rate 0 / {RATE}: {row[f'{kind}_ms_0.0']:.4f} / "
                    f"{row[f'{kind}_ms_{RATE}']:.4f} (eager {eager[f'{kind}_ms']:.4f}, plain eager "
                    f"{eager[f'{kind}_plain_ms']:.4f}, bound {eager[f'{kind}_bound_ms']:.4f}, SDPA forward + backward "
                    f"eager {_ms_or_note(eager, 'bwd_library')}{recorded(kind)})")
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


def unpacked_cell(torch, gen, site, b, dtype, rate, timed=True):
    """One (B, h, S, d) cell: kernel #5 against its plain version and #6 / #7
    (``flash_attention_unpacked_dq`` / ``_dkv``) against theirs, each also
    against the packed kernels (#1, #3, #4) on the same logical inputs
    transposed to (B, S, h*d): the same launches on other strides, so out,
    lse, dQ, dK and dV must be bit-equal. Masked as on the path. ``timed``
    False checks the cell without timing it; timed float32 cells also take
    #6's and #7's device time (CUDA-graph replay)."""
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
    row["bound_ms"], row["bound_by"] = bound_ms(b, sq, sk, h, d, dv, itemsize, masked, dname)
    kernels = {"dq": (fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dq_reference),
               "dkv": (fa.flash_attention_unpacked_dkv, fa.flash_attention_unpacked_dkv_reference)}
    for kind in kernels:
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms(b, sq, sk, h, d, dv, itemsize, masked, dname,
                                                                   kind)
    row["ok"] = ok
    msg = (f"unpacked {name:23s} B={b:<2d} {dname:8s} rate={rate} masked={int(masked)} #5 rel_err={row['rel_err']:.2e} "
           f"lse_err={row['lse_err']:.2e} " + " ".join(f"#{6 if n == 'dq' else 7} {n}={e:.2e}"
                                                       for n, e in row["bwd_rel_err"].items())
           + f"; bit-equal to #1/#3/#4 on the packed layout {row['equal_to_packed']}")
    if timed:
        row["ms"] = time_cuda(torch, lambda: fa.flash_attention_unpacked_fwd(q, k, v, mask, None, rate, seed))
        row["plain_ms"] = time_cuda(torch, lambda: fa.flash_attention_reference(q, k, v, mask, None, rate, seed))
        row["library_ms"], row["library_note"] = sdpa_ms(torch, time_cuda, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, dropout_p=rate))
        for kind, (kernel, reference) in kernels.items():
            row[f"{kind}_ms"] = time_cuda(torch, lambda: kernel(*args))
            row[f"{kind}_plain_ms"] = time_cuda(torch, lambda: reference(*args))
            if dtype is torch.float32:  # the 3xTF32 kernels on the device alone (CUDA-graph replay)
                row[f"{kind}_device_ms"] = device_ms(torch, lambda: kernel(*args))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        row["bwd_library_ms"], row["bwd_library_note"] = sdpa_ms(torch, time_cuda, lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=bias, dropout_p=rate).backward(dout))
        msg += (f"; ms #5={row['ms']:.4f} #6={row['dq_ms']:.4f} #7={row['dkv_ms']:.4f} plain_ms {row['plain_ms']:.4f} / "
                f"{row['dq_plain_ms']:.4f} / {row['dkv_plain_ms']:.4f} sdpa_ms={_ms_or_note(row, 'library')} "
                f"sdpa_fwd_bwd_ms={_ms_or_note(row, 'bwd_library')} bound_ms {row['bound_ms']:.4f} "
                f"({row['bound_by']}) / {row['dq_bound_ms']:.4f} / {row['dkv_bound_ms']:.4f} (eager calls)")
    else:
        msg += " (checked, not timed)"
    log(msg + (" OK" if ok else " FAIL"))
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


def auction_problems(torch, seed, dense, half=TRAIN_B, n=400, num_cls=2):
    """2 x ``half`` problems (the model's 300 top-k queries padded to the
    mini-detector's ``n`` tokens, then the tokens), T=300 targets, one
    class: 32 of N=400 as the 640 px step stacks them by default. With
    ``num_cls`` above 2 (COCO's 81 channels): 1-20 valid targets a problem
    (COCO's 1-20 boxes an image), whose labels run through the num_cls - 1
    classes in turn so that a call with enough targets holds every class,
    and random labels on the invalid columns."""
    gen = torch.Generator().manual_seed(seed)
    b, t = 2 * half, 300
    logits = torch.randn(b, n, num_cls, generator=gen) * 2
    boxes = torch.stack([torch.rand(b, n, generator=gen) * 0.6 + 0.2, torch.rand(b, n, generator=gen) * 0.6 + 0.2,
                         torch.rand(b, n, generator=gen) * 0.35 + 0.05, torch.rand(b, n, generator=gen) * 0.35 + 0.05], -1)
    xy = torch.rand(b, t, 2, generator=gen) * 0.7
    wh = torch.rand(b, t, 2, generator=gen) * 0.28 + 0.02
    tgt = torch.cat([xy, xy + wh], -1)
    labels = torch.zeros(b, t, dtype=torch.int32)
    lo, hi = (150, 301) if dense else ((1, 21) if num_cls > 2 else (1, 9))
    n_valid = torch.randint(lo, hi, (b,), generator=gen)
    valid = torch.arange(t)[None, :] < n_valid[:, None]
    if num_cls > 2:
        labels = torch.randint(0, num_cls - 1, (b, t), generator=gen, dtype=torch.int32)
        labels[valid] = (torch.arange(int(valid.sum())) % (num_cls - 1)).int()
    real = torch.full((b,), n)
    real[:half] = 300
    if dense:
        real[half:half + 4] = 320  # problems with fewer real rows
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


# a captured eval step (train/steps.py::CapturedEvalStep) calls the kernels'
# wrappers in its warm-up and in its capture, once each an input shape; its
# replays call none (count a replayed batch's launches from a trace)
EVAL_CAPTURE_CALLS = 2


def greedy_kernel():
    """The greedy-match wrapper: both metrics' walk, one launch a metric
    update (port-only; it replaces a lax.scan, not a pallas_call)."""
    from object_detection_destr_tpu_torch.ops.cuda.greedy_match import greedy_match_kernel

    return greedy_match_kernel


def reset_counts(kernels) -> None:
    for k in [*kernels, greedy_kernel()]:
        k.launches = 0


def phase_train(torch, kernels, seed, extra=(), per_step=(18, 18, 0, 0, 1, 0, 0, 0, 0), label="hidden 256",
                checkpoints=None, valid=0):
    """The production recipe (+ ``extra`` flags) through the trainer's entry
    point, with an empty validation split (phase 8 validates) or ``valid``
    images, and its checkpoints in a temporary directory or in
    ``checkpoints`` (saved as "train"); ``per_step`` the launches of each
    kernel a step, and beside them 18 #1 and 1 #9 in each of the captured
    eval step's warm-up and capture, and one greedy-match launch a
    validation batch and metric. Returns (the state, the launches, the
    median step ms, the epoch's record)."""
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train import train as train_cli

    config = recipe_config(extra)
    batch, image = config.train.batch_size, config.train.image_size
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build",
                           "chip_smoke_train_" + label.replace(" ", "_"))
    with contextlib.ExitStack() as stack:
        ckpt = checkpoints or stack.enter_context(tempfile.TemporaryDirectory())
        argv = TRAIN_ARGS + list(extra) + ["--seed", str(seed), "--log_dir", log_dir, "--num_valid_samples",
                                           str(valid), "--checkpoint_dir", ckpt, "--save_as", "train"]
        reset_counts(kernels)  # the main path starts here
        t0 = time.perf_counter()
        result = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]  # read just after the main path
        greedy = greedy_kernel().launches
    state = result["state"]
    steps = state.step
    valid_batches = valid // batch
    captures = EVAL_CAPTURE_CALLS if valid_batches else 0
    want = [n * steps for n in per_step]
    want[0] += 18 * captures
    want[4] += captures
    greedy_want = valid_batches * (2 if config.train.coco_eval else 1)
    if steps != TRAIN_STEPS or counts != want or greedy != greedy_want:
        raise AssertionError(f"{steps} steps and {valid_batches} validation batches launched "
                             f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}, and the greedy match "
                             f"{greedy} times, not {greedy_want}")
    metrics = result["metrics"]
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite or missing losses: {metrics}")
    if state.optimizer.count != steps:
        raise AssertionError(f"{state.optimizer.count} of {steps} updates applied")
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
    log(f"train {label}: {steps} steps of the production recipe (B={batch}, {image}px, {config.destr.backbone}"
        f"{' dilated C5' if config.destr.dilation else ''}, {config.destr.compute_dtype}, "
        f"{config.destr.num_encoder_blocks}+{config.destr.num_decoder_blocks} blocks, top_k 300, "
        f"dropout {RATE}, hidden {config.destr.hidden_dim}) and {valid_batches} validation batches in {wall:.1f} s "
        f"(with a _last checkpoint); launches "
        f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} "
        f"({'/'.join(str(n) for n in per_step)} a step, the eval step's warm-up and capture), greedy match "
        f"{greedy}; last losses "
        + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    log(f"train {label}: the matcher's bidding rounds in the last step ({batch} model problems, then {batch} "
        f"mini-detector problems): {kernels[4].last_rounds.tolist()}")
    log(f"train {label}: step ms (CUDA events) {', '.join(f'{t:.1f}' for t in step_ms)}; median after the first "
        f"{median:.2f} ms = {batch / median * 1e3:.1f} images/s; driver's epoch images/s "
        f"{result['images_per_sec']:.1f}; parameters moved {moved}")
    return state, counts, median, (result["history"] or [None])[0]


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
    from object_detection_destr_tpu_torch.train.steps import CapturedEvalStep, make_destr_eval_step

    base = TRAIN_ARGS + ["--seed", str(seed), "--num_valid_samples", str(VALID_SAMPLES), "--checkpoint_dir", ckpt,
                         "--log_dir", os.path.join(ckpt, "runs")]
    argv = base + ["--ema_decay", "0.999", "--coco_eval", "--save_as", "smoke"]
    reset_counts(kernels)  # the validation path starts here
    t0 = time.perf_counter()
    result = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]  # read just after the path
    greedy = greedy_kernel().launches
    state, history = result["state"], result["history"]
    batches = 2 * (VALID_SAMPLES // TRAIN_B)  # the live and the EMA sweep
    # the sweeps share one captured eval step: its warm-up and capture call the wrappers
    want = [18 * (TRAIN_STEPS + EVAL_CAPTURE_CALLS), 18 * TRAIN_STEPS, 0, 0, TRAIN_STEPS + EVAL_CAPTURE_CALLS,
            0, 0, 0, 0]
    if state.step != TRAIN_STEPS or counts != want or greedy != 2 * batches:
        raise AssertionError(f"{state.step} steps and {batches} validation batches launched "
                             f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}, and the greedy match "
                             f"{greedy} times, not {2 * batches}")
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
    if (abs(evaluated["map"] - record["mAP"]) > 1e-6 or evaluated["n_images"] != VALID_SAMPLES
            or eval_launches != 18 * EVAL_CAPTURE_CALLS):
        raise AssertionError(f"evaluate: map {evaluated['map']} over {evaluated['n_images']} images with "
                             f"{eval_launches} #1 launches, the trainer's epoch-0 mAP {record['mAP']}")

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
    captured_step = CapturedEvalStep(eval_step)
    val_captured_ms = time_cuda(torch, lambda: captured_step(state, batch))
    outputs, _ = captured_step(state, batch)
    targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
    metric, coco = MeanAveragePrecision(1, num_pred=300), CocoAveragePrecision(1)
    m_state = metric.init_state("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metric.update(m_state, outputs, targets)
    torch.cuda.synchronize()
    map_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    coco.update(outputs, targets)
    coco_ms = (time.perf_counter() - t0) * 1e3
    del captured_step, outputs
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
    timing = {"val_batch_ms": val_batch_ms, "val_captured_ms": val_captured_ms,
              "val_images_per_sec": VALID_SAMPLES / sweep_s[0], "greedy_launches": greedy,
              "sweep_seconds": sweep_s, "ema_update_ms": ema_ms, "checkpoint_mb": size_mb,
              "checkpoint_save_s": save_s, "eval_launches": eval_launches, "loader_s": loader_s,
              "transform_ms": transform_ms, "map_update_ms": map_ms, "coco_update_ms": coco_ms}
    log(f"validation: {TRAIN_STEPS} steps and {VALID_SAMPLES} validation images (live and EMA sweeps) through "
        f"train.main in {wall:.1f} s; launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} (the eval step's warm-up and "
        f"capture; its replays call no wrapper), greedy match {greedy} (a batch and metric); checkpoints {files}; "
        f"epoch 0 "
        f"mAP={record['mAP']:.6f} coco_mAP={record['coco_mAP']:.6f} ema_mAP={record['ema_mAP']:.6f} "
        f"ema_coco_mAP={record['ema_coco_mAP']:.6f} valid {record['valid']} valid_ema {record['valid_ema']}")
    log(f"validation: infer.evaluate on smoke: map={evaluated['map']:.6f} (driver {record['mAP']:.6f}) "
        f"coco_map={evaluated['coco_map']:.6f}, #1 launched {eval_launches} times; resume from smoke_last went on "
        f"from step {TRAIN_STEPS} to {2 * TRAIN_STEPS} OK")
    log(f"validation: eval step ms a batch of {TRAIN_B}={val_batch_ms:.2f} eager, {val_captured_ms:.2f} captured "
        f"(CUDA events, copy-in and replay); sweep seconds "
        f"{', '.join(f'{t:.2f}' for t in sweep_s)} (host clock, loader + transform + step + metrics, the first "
        f"with the capture) = "
        f"{timing['val_images_per_sec']:.1f} images/s; by part: the host loader {loader_s:.2f} s for "
        f"{VALID_SAMPLES} letterboxed images (host clock), the eval transform {transform_ms:.2f} ms a batch "
        f"(copy and resample, CUDA events), the mAP update {map_ms:.2f} ms (host clock to a synchronize, on the "
        f"device) and the COCO update {coco_ms:.2f} ms a batch (host clock, its one copy to the host inside); EMA "
        f"update ms={ema_ms:.3f} "
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


@contextlib.contextmanager
def forward_widths(kernel, widths):
    """Count the (dtype, d, dv) of each call of the forward wrapper
    ``kernel`` (its class's ``_run``) into the Counter ``widths``."""
    cls = type(kernel)
    original = cls._run

    def recorded(self, query, key, value, num_heads, *args, **kwargs):
        h = num_heads or 1
        widths[(str(query.dtype).split(".")[-1], query.shape[-1] // h, value.shape[-1] // h)] += 1
        return original(self, query, key, value, num_heads, *args, **kwargs)

    cls._run = recorded
    try:
        yield widths
    finally:
        cls._run = original


def phase_serving(torch, kernel, seed, images, service_args=None, label="hidden 256", build=None):
    """Serving through infer.server's build_service: seeded random weights
    written as flax .npz (or ``service_args``, a trained checkpoint and its
    shape flags; or ``build``, which returns a DetectionService), the
    predict captured, requests as replays and eagerly, traced, timed, and
    the HTTP front end."""
    from object_detection_destr_tpu_torch.config import DestrConfig
    from object_detection_destr_tpu_torch.infer.server import _make_handler, build_service, get_parser
    from object_detection_destr_tpu_torch.models.convert import (
        flax_variables_from_state_dict,
        save_variables_npz,
    )
    from object_detection_destr_tpu_torch.models.destr.model import build_destr

    start = time.perf_counter()
    variables = None
    if service_args is None and build is None:
        weights_dir = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "object_detection_destr_tpu_torch", "_build"
        )
        os.makedirs(weights_dir, exist_ok=True)
        source = build_destr(DestrConfig(), "cuda")
        randomize_(torch, source, seed)
        variables = flax_variables_from_state_dict(source)
        del source
        save_variables_npz(variables, os.path.join(weights_dir, "chip_smoke_weights.npz"))
        service_args = ["--checkpoint_dir", weights_dir, "--weights", "chip_smoke_weights.npz", "--score_thresh", "0.0"]
    if build is None:
        args = get_parser().parse_args(service_args)
        build = lambda: build_service(args)  # noqa: E731 — default: GPU, 640px, letterbox, the predict captured
    kernel.launches = 0  # the main path starts here: the service's warm-up forward and capture, then requests
    with forward_widths(kernel, collections.Counter()) as widths:
        service = build()
    built = kernel.launches
    log(f"serving {label}: weights ready and service built (warm-up forward and CUDA-graph capture) in "
        f"{time.perf_counter() - start:.1f} s ({sum(p.numel() for p in service.model.parameters()) / 1e6:.1f} M "
        f"parameters); #1's wrapper called {built} times (the warm-up forward's and the capture's), by (dtype, d, "
        f"dv) {dict(widths)}")
    config = service.model.config
    blocks = config.num_decoder_blocks
    if config.num_encoder_blocks != blocks:
        raise AssertionError(f"serving {label}: {config.num_encoder_blocks} encoder and {blocks} decoder blocks")
    if service.graph is None or built != 2 * 3 * blocks or sum(widths.values()) != built:
        raise AssertionError(f"the service captured no graph, or called #1 {built} times building it")
    hidden, size = service.model.config.hidden_dim, service.image_size
    want_widths = {("float32", hidden // 8, hidden // 8), ("float32", 2 * hidden // 8, 2 * hidden // 8),
                   ("float32", 2 * hidden, hidden)}
    if set(widths) != want_widths or set(widths.values()) != {2 * blocks}:
        raise AssertionError(f"#1 served at (dtype, d, dv) {dict(widths)}, not {sorted(want_widths)} "
                             f"{2 * blocks} times each")

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
        windows[kind] = traced(torch, f"serve_{kind}_{label.replace(' ', '_')}", len(images), requests)
        if windows[kind]["per_step"] != [3.0 * blocks, 0, 0, 0, 0, 0]:
            raise AssertionError(f"a traced {kind} request launched #1/#2/#3/#4/#9/#8 {windows[kind]['per_step']} "
                                 f"(launch lead {windows[kind]['launch_lead_s']} s)")
    log(f"serving {label}: {len(latencies)} captured requests (graph replays, #1's wrapper not called), detections scoring "
        f">= 0.5 {dict(zip(['x'.join(map(str, im.shape[:2])) for im in images], counts))}; the eager forward "
        f"gives the same detections on every request")
    log(f"serving {label}: request latency ms captured median={statistics.median(latencies):.2f} "
        f"min={min(latencies):.2f} max={max(latencies):.2f} (all: {', '.join(f'{t:.2f}' for t in latencies)}); "
        f"eager median={statistics.median(eager_latencies):.2f} max={max(eager_latencies):.2f} (all: "
        f"{', '.join(f'{t:.2f}' for t in eager_latencies)})")
    log(f"serving {label}: traced requests (4 each): " + "; ".join(
        f"{kind} device busy {w['step_busy_ms']:.3f} ms a request of {w['step_period_ms']:.3f}, idle share "
        f"{w['idle_share']:.4f}, #1 launches a request from the trace {w['per_step'][0]:.0f}"
        for kind, w in windows.items()))
    serve_timing = {"captured_ms": statistics.median(latencies), "captured_max_ms": max(latencies),
                    "eager_ms": statistics.median(eager_latencies), "eager_max_ms": max(eager_latencies),
                    **{f"{kind}_{key}": w[key] for kind, w in windows.items()
                       for key in ("idle_share", "step_busy_ms", "step_period_ms", "kernel_ms")}}

    # where a request's time goes: host letterbox, then the model on the device
    from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas

    host_ms = []
    for image in images:
        t0 = time.perf_counter()
        _letterbox_canvas(image, size)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"serving {label}: host letterbox ms per image {', '.join(f'{t:.2f}' for t in host_ms)}")
    # one model forward alone, on the device clock
    canvas = torch.zeros((1, size, size, 3), device="cuda")
    parts = forward_parts(torch, service.model, canvas)
    forward_ms = parts.pop("forward")
    log(f"serving {label}: model forward B=1 ms={forward_ms:.2f} (CUDA events); by part ms "
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
    log(f"serving {label}: HTTP /healthz ok")
    return service, variables, main_path_launches, serve_timing, forward_ms


def phase_h1024_service(torch, kernels, seed, images):
    """Hidden 1024 validated, evaluated and served from its own checkpoint:
    train.main with the production recipe and H1024_ARGS (--hidden_dim 1024
    at H1024_BLOCKS blocks) for 2 steps and a 16-image validation split
    (H1024_PER_STEP launches of #1 / #2 / #3 / #4 / #9 a step, 3 #1 a block
    and 1 #9 the validation batch, COCO AP beside the mAP), its checkpoint
    written; infer.evaluate.main on it reproduces the driver's mAP and COCO
    AP (1e-6) with 3 #1 launches a block; infer.server's build_service restores it and serves
    the requests as phase 8 does, every #1 call float32, the
    cross-attention's at d 2048, dv 1024. Returns what it measured."""
    from object_detection_destr_tpu_torch.infer import evaluate
    from object_detection_destr_tpu_torch.ops.cuda import flash_attention as fa
    from object_detection_destr_tpu_torch.train import train as train_cli

    steps = 2
    with tempfile.TemporaryDirectory() as ckpt:
        base = TRAIN_ARGS + H1024_ARGS + ["--seed", str(seed), "--num_train_samples", str(TRAIN_B * steps),
                                          "--num_valid_samples", str(TRAIN_B), "--checkpoint_dir", ckpt,
                                          "--log_dir", os.path.join(ckpt, "runs"), "--coco_eval"]
        reset_counts(kernels)  # the hidden-1024 validation path starts here
        t0 = time.perf_counter()
        result = train_cli.main(base + ["--save_as", "h1024"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]  # read just after the path
        want = [n * steps for n in H1024_PER_STEP]
        want[0] += 3 * H1024_BLOCKS * EVAL_CAPTURE_CALLS  # the captured eval step's warm-up and capture
        want[4] += EVAL_CAPTURE_CALLS
        record = result["history"][0]
        if result["state"].step != steps or counts != want or not math.isfinite(record["mAP"]):
            raise AssertionError(f"hidden 1024: {result['state'].step} steps and a validation batch launched "
                                 f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} times, not {want}; mAP {record['mAP']}")
        size_mb = os.path.getsize(os.path.join(ckpt, "h1024")) / 1e6
        del result
        torch.cuda.empty_cache()
        before = kernels[0].launches
        evaluated = evaluate.main(base + ["--resume_from", "h1024"])
        eval_launches = kernels[0].launches - before
        if (abs(evaluated["map"] - record["mAP"]) > 1e-6 or abs(evaluated["coco_map"] - record["coco_mAP"]) > 1e-6
                or evaluated["n_images"] != TRAIN_B or eval_launches != 3 * H1024_BLOCKS * EVAL_CAPTURE_CALLS):
            raise AssertionError(f"evaluate hidden 1024: map {evaluated['map']} coco_map {evaluated['coco_map']} over "
                                 f"{evaluated['n_images']} images with {eval_launches} #1 launches, the driver's mAP "
                                 f"{record['mAP']} coco_mAP {record['coco_mAP']}")
        log(f"hidden 1024: train.main {steps} steps and a {TRAIN_B}-image validation batch in {wall:.1f} s, launches "
            f"#1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}, mAP={record['mAP']:.6f} coco_mAP={record['coco_mAP']:.6f}, "
            f"checkpoint {size_mb:.1f} MB; infer.evaluate on it: map={evaluated['map']:.6f} coco_map="
            f"{evaluated['coco_map']:.6f} (driver {record['mAP']:.6f}, {record['coco_mAP']:.6f}), #1 launched "
            f"{eval_launches} times OK")
        served = phase_serving(torch, fa.flash_attention_fwd, seed, images, label="hidden 1024", service_args=[
            "--checkpoint_dir", ckpt, "--weights", "h1024", "--score_thresh", "0.0", *H1024_ARGS])
    service, _, serve_launches, serve_timing, forward_ms = served
    del service
    torch.cuda.empty_cache()
    return {"counts": counts, "eval_launches": eval_launches, "map": evaluated["map"], "checkpoint_mb": size_mb,
            "serve_launches": serve_launches, **serve_timing, "forward_ms": forward_ms}


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
KERNEL_NAME_PATTERNS = [r"flash_fwd_(tc|f32)_kernel", r"flash_bwd_(tc|f32)_kernel",
                        r"flash_two_pass_(tc|f32)(_wide)?_kernel(<false|ILb0E)",
                        r"flash_two_pass_(tc|f32)(_wide)?_kernel(<true|ILb1E)",
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


def trace_kernel_ms(parsed) -> list:
    """Device ms a step of #1, #2, #3, #4, #9, #8 in a parsed trace."""
    import re

    out = [0.0] * len(KERNEL_NAME_PATTERNS)
    for name, entry in parsed["device_time"].items():
        for i, pattern in enumerate(KERNEL_NAME_PATTERNS):
            if re.search(pattern, name):
                out[i] += entry["seconds"] * 1e3 / len(parsed["steps"])
                break
    return out


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
    parsed["kernel_ms"] = trace_kernel_ms(parsed)
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


CHUNK = 1 << 25  # elements a pass over a state-sized vector: bounds its float64 temporaries (hidden 1024: 436 M)


def _chunks(n):
    return [slice(i, i + CHUNK) for i in range(0, n, CHUNK)]


def _mean_sample(samples):
    """The float64 mean of equally shaped samples, computed a chunk at a
    time; equal samples give their own value, not a rounding of it."""
    import torch

    flat = [torch.as_tensor(x).reshape(-1) for x in samples]
    out = torch.empty(flat[0].shape, dtype=torch.float64, device=flat[0].device)
    for c in _chunks(out.numel()):
        stack = torch.stack([x[c].double() for x in flat])
        out[c] = stack[0] + (stack - stack[0]).mean(0)
    return out.reshape(torch.as_tensor(samples[0]).shape)


def dist(a, b, key):
    """The distance of two samples' ``key``: the mean absolute difference of
    the losses, the 2-norm of the difference of a vector (Adam's first
    moment, the parameters), in float64, a chunk at a time."""
    import torch

    a, b = (torch.as_tensor(x).reshape(-1) for x in (a, b))
    if key == "losses":
        return float((a.double() - b.double()).abs().mean())
    return math.sqrt(sum(float((a[c].double() - b[c].double()).pow(2).sum()) for c in _chunks(a.numel())))


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
    canvas = int(cfg.image_size * 672 / 640)  # the trainer's canvas
    cache = DeviceCachedLoader(_make_loaders(config, canvas, "destr")[0], "cuda")
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


def phase_captured_train(torch, kernels, setup, per_step, label, exact=False, eager_runs=EAGER_RUNS,
                         held_steps=TRAIN_STEPS):
    """A recipe's step on device-cached batches (``setup``: its state, cache,
    steps, transform and augmentation seeds), captured against eager from the
    same state and seed: the
    epoch runner takes step 0 (its eager warm-up on a side stream, then the
    capture); at each of steps 1-4 the state is cloned and, each from the
    clone, the eager per-step path runs ``eager_runs`` times (the first under
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
    and peak memory are this capture's.

    ``eager_runs``: 5, or 3 at hidden 1024, whose 436 M parameters make
    each sample of the moment and the parameters 3.5 GB on the card beside
    the graph's 24 GB pool (a largest pair of 3 samples is the narrower
    limit).

    ``held_steps``: the steps after the capture held this way (HELD_STEPS
    in phases 6a and 14, to keep the script inside its time limit)."""
    from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner

    t_start = time.perf_counter()

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
        # the step's freed activations, cached in blocks that a state-sized
        # vector does not fit (hidden 1024: 1.7 GB each beside a 24 GB graph pool)
        torch.cuda.empty_cache()
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
        spread, losses = {}, {"eager": [[] for _ in range(eager_runs)], "captured": [], "seed_of_step_0": []}
        for step in range(1, held_steps + 1):
            snapshot = [t.detach().clone() for t in _state_tensors(state)]
            start = {"m": torch.cat([m.reshape(-1) for m in state.optimizer._m.values()]),
                     "params": _flat_params(torch, state.model)}
            if state.optimizer.accumulated is not None:
                start["acc"] = state.optimizer.accumulated.clone()
            eager = []
            for k in range(eager_runs):
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
            torch.cuda.empty_cache()  # for the statistics' float64 temporaries
            # each vector relative to the step's change (the eager samples' mean
            # change; absolute where the step changed nothing: a mini-step that
            # does not emit leaves the moments and the parameters)
            for key in start:
                origin = start[key].reshape(-1)
                norm = dist(_mean_sample([e[key] for e in eager]).to(origin.device), origin, key) or 1.0
                for smp in (*eager, *replays.values()):
                    flat = smp[key].view(-1)  # in place, a chunk at a time
                    for c in _chunks(flat.numel()):
                        flat[c] = ((flat[c].double() - origin[c].double()) / norm).float()
            for k, e in enumerate(eager):
                losses["eager"][k] += e.pop("losses")
            for name, r in replays.items():
                losses[name] += r.pop("losses")
            spread[f"step {step}"] = _hold_to_spread(f"captured step {label}, step {step}", eager,
                                                     replays["captured"], {"seed_of_step_0": replays["seed_of_step_0"]})
            del eager, replays, start
        spread["losses"] = _hold_to_spread(
            f"captured step {label}, losses of steps 1-{held_steps}", [{"losses": e} for e in losses["eager"]],
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
    held_s = time.perf_counter() - t_start
    log(f"captured step {label}: step 0 the runner's warm-up and capture; steps 1-{held_steps} each from one "
        f"cloned state, {eager_runs} eager samples, the replay and a replay with step 0's seeds (planted fault); "
        f"distances to the eager mean (m: Adam's first moment, params: parameters, both as 2-norms relative to "
        f"the step's change, so a step that applied no update is at 1.0; losses: mean absolute difference over "
        f"the {held_steps} steps' losses) and limit = the largest eager pair{EXACT_NOTE if exact else ''} "
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
              for key in ("idle_share", "step_busy_ms", "step_period_ms", "per_step", "kernel_ms", "unattributed")}}
    log(f"captured step {label}: step ms (CUDA events, in turns E C C E, 3 each) eager {out['eager_ms']:.2f} "
        f"({', '.join(f'{t:.2f}' for t in times['eager'])}), captured {out['captured_ms']:.2f} "
        f"({', '.join(f'{t:.2f}' for t in times['captured'])}); traced window of 3 steps: eager device busy "
        f"{out['eager_step_busy_ms']:.2f} ms a step of {out['eager_step_period_ms']:.2f}, idle share "
        f"{out['eager_idle_share']:.4f}; captured busy {out['captured_step_busy_ms']:.2f} ms of "
        f"{out['captured_step_period_ms']:.2f}, idle share {out['captured_idle_share']:.4f}; launches a step "
        f"from the trace #1/#2/#3/#4/#9/#8 eager {windows['eager']['per_step']} captured "
        f"{windows['captured']['per_step']}; their device ms a step eager "
        f"{[round(x, 4) for x in windows['eager']['kernel_ms']]} captured "
        f"{[round(x, 4) for x in windows['captured']['kernel_ms']]}; peak memory above the state's (max_memory_allocated) of an eager "
        f"step {out['eager_step_peak_gb']:.2f} GB, of the runner's warm-up and capture "
        f"{out['captured_peak_gb']:.2f} GB, allocated after them (gradients, the graph's outputs) "
        f"{out['graph_held_gb']:.2f} GB, reserved by the allocator since the runner began (the graph's private "
        f"pool among it) {out['reserved_added_gb']:.2f} GB; seconds: capture and {held_steps} held steps "
        f"{held_s:.1f}, in all {time.perf_counter() - t_start:.1f}")
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


def ssd_capture_setup(torch, seed, config=None):
    """SSD_ARGS' state (or ``config``'s), device cache, transform, steps and
    augmentation seeds (offset 13, as the SSD driver's) for
    :func:`phase_captured_train`."""
    from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader
    from object_detection_destr_tpu_torch.data.transforms import ssd_train_transform
    from object_detection_destr_tpu_torch.models.ssd import build_ssd
    from object_detection_destr_tpu_torch.train.driver import _aug_seed, _make_loaders
    from object_detection_destr_tpu_torch.train.state import create_ssd_state
    from object_detection_destr_tpu_torch.train.steps import make_ssd_step_core, make_ssd_train_step

    config = config or ssd_recipe_config(["--seed", str(seed)])
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


def phase_ssd_serving(torch, kernels, seed, images, service_args=None, label="serve ssd 300"):
    """serve-ssd-300: ``build_service --model ssd`` with seeded random
    weights (flax's initialisers, written as the .npz the server loads), or
    with ``service_args`` (the server's flags: a trained checkpoint), the B=1
    predict captured at startup; the requests (``images``: four aspect
    ratios, twice) as graph replays and the same eagerly, the detections
    equal; latencies; a torch.profiler trace of 4 requests of each (device
    busy time, idle share); the model forward on the card against the CPU's
    (float32, TF32 off, 1e-4 of each head's largest value). Launches of the
    nine kernels: none."""
    from object_detection_destr_tpu_torch.config import SSDConfig
    from object_detection_destr_tpu_torch.infer.server import build_service, get_parser
    from object_detection_destr_tpu_torch.models.convert import flax_variables_from_state_dict, save_variables_npz
    from object_detection_destr_tpu_torch.models.ssd import build_ssd

    if service_args is None:
        weights_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build")
        os.makedirs(weights_dir, exist_ok=True)
        torch.manual_seed(seed)
        save_variables_npz(flax_variables_from_state_dict(build_ssd(SSDConfig(), "cpu")),
                           os.path.join(weights_dir, "chip_smoke_ssd.npz"))
        service_args = ["--checkpoint_dir", weights_dir, "--weights", "chip_smoke_ssd.npz", "--score_thresh", "0.0"]
    args = get_parser().parse_args(["--model", "ssd", *service_args])
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
                    not 0 <= c < service.model.config.num_cls for c in dets["labels"]):
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
    cpu_model = build_ssd(service.model.config, "cpu")
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
    log(f"{label}: service built (warm-up and capture) in {built_s:.1f} s; {len(latencies)} captured "
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
    eager, 18 / 18 / 1 of #1 / #2 / #9 a mini-step; captured, the runner's
    warm-up step and its capture call the wrappers (a replay does not); in
    both, the sweep's captured eval step's warm-up and capture, 18 / 0 / 1
    each. Moments bfloat16, 2 updates
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
            # and the sweep's captured eval step: its warm-up and its capture
            want = [18 * (calls + EVAL_CAPTURE_CALLS), 18 * calls, 0, 0, calls + EVAL_CAPTURE_CALLS, 0, 0, 0, 0]
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
                                                 REMAT_LAUNCHES[:6], "real data remat", held_steps=HELD_STEPS)
        del remat_state
        torch.cuda.empty_cache()
        captured = phase_captured_train(torch, kernels, setup, (18, 18, 0, 0, 1, 0), "real data",
                                        held_steps=HELD_STEPS)
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
# the resumes the replay is held against, and the factor on their largest gap
# that bounds its gap to the nearest: from 48 runs of the second step on the
# card (artifacts/port_f32_bwd_r1/postmortem_noise.py; PERF.md), 4 resumes and
# twice their gap failed 0.6 % of fault-free draws, 10 and once 0.04 %, and
# 10 and once fail more often at every shift of 3 or more standard deviations
PM_RESUMES, PM_FACTOR = 10, 1.0
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
    # the orders' sweeps share one captured eval step: its warm-up and capture
    want = [18 * EVAL_CAPTURE_CALLS, 0, 0, 0, EVAL_CAPTURE_CALLS, 0, 0, 0, 0]
    if not (out["order_invariant"] and out["per_image_rows_reproduce_sweep"]) or counts != want \
            or out["n_images"] != VALID_SAMPLES:
        raise AssertionError(f"val_noise: {out}; launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}, not {want}")
    log(f"tools ({card}): val_noise on smoke, {VALID_SAMPLES} images x {NOISE_ORDERS} orders in {seconds:.1f} s: "
        f"order_invariant {out['order_invariant']}, per_image_rows_reproduce_sweep "
        f"{out['per_image_rows_reproduce_sweep']}, launches {counts} (18 #1 and 1 #9 in the eval step's warm-up "
        f"and capture; {batches} batches replayed)")
    return {**out, "launches": counts, "seconds": seconds}


def pm_verdict(replay, logs, factor=PM_FACTOR) -> dict:
    """Phase 17 (b)'s criterion on a replay's rows of PM_KEYS by step
    against the resumes' (``logs``): the first step equal to every resume's
    to 1e-6, and the replay's largest gap to the nearest resume within
    ``factor`` times the resumes' largest gap + 1e-6."""
    gap = lambda a, b, upto=PM_STEPS: max(abs(x - y) for ra, rb in zip(a[:upto], b[:upto]) for x, y in zip(ra, rb))
    out = {"first_gap": max(gap(replay, log_, 1) for log_ in logs),
           "replay_gap": min(gap(replay, log_) for log_ in logs),
           "resume_gap": max(gap(a, b) for a in logs for b in logs)}
    out["ok"] = out["first_gap"] <= 1e-6 and out["replay_gap"] <= factor * out["resume_gap"] + 1e-6
    return out


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
    over all steps and losses, must stay within PM_FACTOR times the largest
    gap between two resumes plus 1e-6. 18 / 18 / 1 launches of #1 / #2 / #9
    a replayed step."""
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
    verdict = pm_verdict(replay, logs)
    first_gap, replay_gap, resume_gap = verdict["first_gap"], verdict["replay_gap"], verdict["resume_gap"]
    want = [18 * PM_STEPS, 18 * PM_STEPS, 0, 0, PM_STEPS, 0, 0, 0, 0]
    if not verdict["ok"] or counts != want or out["first_nonfinite_step"] is not None:
        raise AssertionError(f"postmortem: the replay's first step {first_gap} from the resumes' (limit 1e-6), its "
                             f"losses {replay_gap} from the nearest resume, the resumes up to {resume_gap} apart "
                             f"(limit {PM_FACTOR} x that + 1e-6); launches {counts}, not {want}; first non-finite step "
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


LAUNCH_TIMEOUT_S = 300  # phase 18: each subprocess, its process group killed past it
LAUNCHER_VALID = 32  # phase 18: two validation batches of 16
# phase 18's cuts of the recipes: one epoch of 2 steps each, the widths kept
LAUNCHER_CUTS = {
    "train_prod_synth_torch.sh": ["--epochs", "1", "--num_train_samples", "32", "--num_valid_samples",
                                  str(LAUNCHER_VALID), "--epoch_scan", "--log_interval", "1"],
    "train_prod_ssd_torch.sh": ["--epochs", "1", "--num_train_samples", "64", "--num_valid_samples",
                                str(LAUNCHER_VALID), "--log_interval", "1"],
}
LAUNCHER_TAGS = {
    "train_prod_synth_torch.sh": ("Perf/images_per_sec", "Loss/valid/loss_model", "Metric/mAP", "Metric/coco_mAP",
                                  "Loss/valid_ema/loss_model", "Metric/ema_mAP", "Metric/ema_coco_mAP"),
    "train_prod_ssd_torch.sh": ("Perf/images_per_sec", "Loss/valid/loss", "Metric/mAP"),
}
LAUNCHER_CHECKPOINTS = {"train_prod_synth_torch.sh": ("prod_r4", "prod_r4_ema", "prod_r4_last"),
                        "train_prod_ssd_torch.sh": ("ssd_prod", "ssd_prod_last")}
# the interpreter the launchers find first on PATH in phase 18: it runs
# ``python -m MODULE ...`` as python would and writes the nine wrappers'
# launch counts of that process to $CHIP_SMOKE_LAUNCHES at its end
LAUNCH_COUNTING_PYTHON = """#!{python}
import json, os, runpy, sys
if sys.argv[1:2] != ["-m"]:
    os.execv(sys.executable, [sys.executable, *sys.argv[1:]])
module = sys.argv[2]
sys.argv = [module, *sys.argv[3:]]
sys.path.insert(0, os.getcwd())
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    from {pkg}.ops.cuda import auction, flash_attention as fa
    kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
               auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
               fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]
    with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
        json.dump([k.launches for k in kernels], f)
"""


def run_launched(cmd, work, label, card) -> tuple[list, str, float]:
    """``cmd`` in its own process group with the launch-counting python
    first on PATH, killed with its group after LAUNCH_TIMEOUT_S; returns
    (its nine launch counts, its stdout, its seconds). Fails on a non-zero
    exit or a timeout."""
    import signal

    counts_path = os.path.join(work, f"{label}_launches.json")
    env = {**os.environ, "PATH": os.path.join(work, "bin") + os.pathsep + os.environ.get("PATH", ""),
           "CHIP_SMOKE_LAUNCHES": counts_path}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"launchers: {label} passed its {LAUNCH_TIMEOUT_S} s limit; its output ends:\n"
                             + out[-4000:])
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launchers: {label} exited {proc.returncode}; its output ends:\n{out[-4000:]}")
    with open(counts_path) as f:
        counts = json.load(f)
    log(f"launchers ({card}) {label}: exit 0 in {seconds:.1f} s, launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}")
    return counts, out, seconds


def phase_launchers(card):
    """Phase 18, the port's launchers: scripts/train_prod_synth_torch.sh and
    scripts/train_prod_ssd_torch.sh run as subprocesses with LAUNCHER_CUTS
    appended (the recipes' widths kept), then infer.evaluate on the DESTR
    checkpoint they wrote; each subprocess's exit code, tags, checkpoints
    and launch counts checked."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, PKG, "_build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_launchers_", dir=os.path.join(root, PKG, "_build"))
    out = {}
    try:
        os.makedirs(os.path.join(work, "bin"))
        shim = os.path.join(work, "bin", "python")
        with open(shim, "w") as f:
            f.write(LAUNCH_COUNTING_PYTHON.format(python=sys.executable, pkg=PKG))
        os.chmod(shim, 0o755)
        logged = {}
        for script, cut in LAUNCHER_CUTS.items():
            ckpt, logs = os.path.join(work, script + ".ckpt"), os.path.join(work, script + ".runs")
            counts, _, seconds = run_launched(["bash", os.path.join(root, "scripts", script), *cut,
                                               "--checkpoint_dir", ckpt, "--log_dir", logs], work, script, card)
            with open(os.path.join(logs, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            tags = {r["tag"]: r["value"] for r in records if "tag" in r}
            train_steps = sorted(r["step"] for r in records if r.get("prefix") == "train")
            missing = [t for t in LAUNCHER_TAGS[script] if t not in tags]
            absent = [n for n in LAUNCHER_CHECKPOINTS[script] if not os.path.exists(os.path.join(ckpt, n))]
            values = [tags[t] for t in LAUNCHER_TAGS[script] if t in tags]
            if missing or absent or train_steps != [1, 2] or not all(math.isfinite(v) for v in values):
                raise AssertionError(f"launchers: {script}: tags missing {missing}, checkpoints missing {absent}, "
                                     f"train steps logged {train_steps}, values {values}")
            # DESTR: the epoch runner's eager warm-up step and its capture (a
            # replay calls no wrapper), 18 / 18 / 1 each, and the live and
            # EMA sweeps' captured eval step, its warm-up and capture 18 #1
            # and 1 #9 each; SSD: none of the nine
            calls = 2 + EVAL_CAPTURE_CALLS
            want = ([18 * calls, 18 * 2, 0, 0, calls, 0, 0, 0, 0]
                    if script == "train_prod_synth_torch.sh" else list(NO_LAUNCHES))
            if counts != want:
                raise AssertionError(f"launchers: {script} launches {counts}, not {want}")
            logged[script] = tags
            out[script] = {"seconds": seconds, "launches": counts,
                           "tags": {t: tags[t] for t in LAUNCHER_TAGS[script]}}
        # the evaluator on the DESTR launcher's best checkpoint, the recipe's shape flags
        script = "train_prod_synth_torch.sh"
        counts, printed, seconds = run_launched(
            [shim, "-m", f"{PKG}.infer.evaluate", "--dataset", "synthetic", "--synthetic_size", "672",
             "--image_size", "640", "--batch_size", str(TRAIN_B), "--compute_dtype", "bfloat16",
             "--num_encoder_blocks", "6", "--num_decoder_blocks", "6", "--top_k", "300",
             "--num_valid_samples", str(LAUNCHER_VALID), "--checkpoint_dir", os.path.join(work, script + ".ckpt"),
             "--resume_from", "prod_r4"], work, "evaluate", card)
        result = json.loads(printed.strip().splitlines()[-1])
        # the evaluator prints to 5 places; the trainer's sweep on the same weights is the same computation
        gaps = [abs(result["map"] - logged[script]["Metric/mAP"]),
                abs(result["coco_map"] - logged[script]["Metric/coco_mAP"])]
        if (result["n_images"] != LAUNCHER_VALID or counts != [18 * EVAL_CAPTURE_CALLS] + [0] * 8
                or max(gaps) > 1e-5):
            raise AssertionError(f"launchers: evaluate printed {result}, launches {counts} (18 #1 in the captured "
                                 f"forward's warm-up and capture expected), gaps to the trainer's mAP / COCO AP {gaps}")
        out["evaluate"] = {"seconds": seconds, "launches": counts, "map": result["map"],
                           "coco_map": result["coco_map"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"launchers ({card}): train_prod_synth_torch.sh {out['train_prod_synth_torch.sh']['seconds']:.1f} s, "
        f"train_prod_ssd_torch.sh {out['train_prod_ssd_torch.sh']['seconds']:.1f} s, evaluate "
        f"{out['evaluate']['seconds']:.1f} s (map {out['evaluate']['map']}, coco_map "
        f"{out['evaluate']['coco_map']}, the trainer's logged values within 1e-5); phase {out['seconds']:.1f} s")
    return out


# ---- slice 15: BASELINE.json's config 4 (DESTR-R101, dilated C5, 1333 px)
FORWARD_SITES = ["encoder_self"] * BLOCKS + ["decoder_self", "cross_cls_reg"] * BLOCKS  # #1's order in a step


def flash_site_ms(trace_dir, steps):
    """#1's and #2's device ms a step at each call site, from the kernel
    events of a trace of ``steps`` DESTR steps in the order they ran: a
    forward launches #1 at the encoder's blocks, then at each decoder
    block's self- and cross-attention; the backward launches #2 at the same
    sites in the reverse order. Each site's events must share one kernel
    name and grid, which a wrong attribution would mix."""
    import re

    from object_detection_destr_tpu_torch.train.profiler import _newest_trace

    with open(_newest_trace(trace_dir)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = {}
    for kernel, pattern, order in (("#1", KERNEL_NAME_PATTERNS[0], FORWARD_SITES),
                                   ("#2", KERNEL_NAME_PATTERNS[1], FORWARD_SITES[::-1])):
        found = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                        and re.search(pattern, e.get("name", ""))), key=lambda e: float(e["ts"]))
        if len(found) != len(order) * steps:
            raise AssertionError(f"{kernel}: {len(found)} launches in a trace of {steps} steps, not "
                                 f"{len(order) * steps}")
        ms, shapes = {}, {}
        for i, e in enumerate(found):
            site = order[i % len(order)]
            ms[site] = ms.get(site, 0.0) + float(e.get("dur", 0.0)) / 1e3 / steps
            shapes.setdefault(site, set()).add((e["name"], str(e.get("args", {}).get("grid"))))
        if any(len(v) != 1 for v in shapes.values()) or len({next(iter(v)) for v in shapes.values()}) != len(shapes):
            raise AssertionError(f"{kernel}: the launches by position do not fall into one shape a site: {shapes}")
        out[kernel] = ms
    return out


def fused_auction_cell(torch, label, args):
    """#9 on ``args`` (auction_problems') against its plain version: rows,
    rounds and bids equal; the wrapper's eager call, the launch alone
    (device ms, CUDA graph) and the plain version timed, and the bound."""
    from object_detection_destr_tpu_torch.ops.cuda.auction import (
        fused_auction,
        fused_auction_operands,
        hungarian_match_fused_reference,
    )

    rows_k, rounds_k = fused_auction(*args)
    torch.cuda.synchronize()
    bids = fused_auction.last_bids.cpu().long()
    plain_bids = torch.zeros(args[0].shape[0], dtype=torch.long, device="cuda")
    rows_p, rounds_p = hungarian_match_fused_reference(*args, bids_out=plain_bids)
    if not (torch.equal(rows_k, rows_p) and rounds_k.cpu().long().tolist() == rounds_p.cpu().tolist()
            and bids.tolist() == plain_bids.cpu().tolist()):
        raise AssertionError(f"{label} #9: rows, rounds {rounds_k.tolist()} / {rounds_p.tolist()} or bids "
                             f"{bids.tolist()} / {plain_bids.tolist()} differ from the plain version's")
    operands = fused_auction_operands(*args)
    cell = {"ms": time_cuda(torch, lambda: fused_auction(*args)),
            "kernel_device_ms": device_ms(torch, lambda: fused_auction.launch(operands)),
            "plain_ms": time_cuda(torch, lambda: hungarian_match_fused_reference(*args), reps=3),
            "rounds": rounds_k.cpu().tolist(), "bids": int(bids.sum())}
    cell["bound_ms"], cell["bound_by"] = auction_bound(args, args[4], args[5], bids, l2_rate(torch))
    return cell


def c4_kernels(torch, seed):
    """The kernels at config 4's shapes against their plain versions: #1
    and the plan's backward (#2) at the step's three sites (B=1, bfloat16,
    dropout 0.3, masked as on the path), and #9 on the step's 2 problems of
    N = 7056 rows (the 300 queries padded to the tokens, then the tokens),
    at most 8 valid targets: rows, rounds and bids equal to the plain
    version's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flash = [flash_cell(torch, gen, site, 1, torch.bfloat16, RATE, site[-1], "plan", False)
             for site in (SITES[3], SITES[1], SITES[4])]  # the encoder's, the decoder's and the cross sites
    if not all(r["ok"] and r["bwd_plan"] == "fused" for r in flash):
        raise AssertionError(f"{C4_LABEL}: flash cells out of tolerance or off #2: {flash}")
    args = auction_problems(torch, seed, False, half=1, n=C4_TOKENS)
    auction = fused_auction_cell(torch, C4_LABEL, args)
    log(f"{C4_LABEL} #9: 2 problems N={C4_TOKENS} T=300, valid targets {args[4].sum(1).tolist()}: rows, rounds "
        f"{auction['rounds']} and bids {auction['bids']} equal to the plain version's; ms={auction['ms']:.4f} (eager "
        f"call) kernel_device_ms={auction['kernel_device_ms']:.4f} plain_ms={auction['plain_ms']:.2f} "
        f"bound_ms={auction['bound_ms']:.6f} ({auction['bound_by']})")
    return flash, auction


def c4_serving(torch, kernels, seed, ckpt, weights):
    """Requests at 1333 px, float32, letterboxed, four aspects: through
    infer.cli (one invocation a request, 18 #1 launches each, from the
    checkpoint ``weights`` in ``ckpt``), then phase 8's serving on a
    DetectionService whose model infer.server.build_model builds (the
    server's flags have no --dilation, as in the JAX package); the CLI's
    detections within 1e-5 of the captured service's. Returns what phase 8
    measured and the CLI's seconds."""
    import numpy as np
    from PIL import Image

    from object_detection_destr_tpu_torch.infer import cli, server

    gen = torch.Generator().manual_seed(seed)
    images = [torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8).numpy()
              for h, w in C4_REQUEST_SIZES]
    flags = ["--checkpoint_dir", ckpt, "--weights", weights, "--score_thresh", "0.0", "--image_size",
             str(C4_IMAGE), "--backbone", "resnet101"]
    records, cli_s = [], []
    for i, image in enumerate(images):
        path = os.path.join(ckpt, f"request_{i}.png")
        Image.fromarray(image).save(path)
        reset_counts(kernels)  # a request through the CLI starts here
        t0 = time.perf_counter()
        records += cli.main(flags + ["--dilation", "--images", path, "--output", os.path.join(ckpt, "dets.json")])
        torch.cuda.synchronize()
        cli_s.append(time.perf_counter() - t0)
        counts = [k.launches for k in kernels]
        if counts != [3 * BLOCKS] + [0] * 8:
            raise AssertionError(f"cli request {i}: #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}, not 18 #1")

    def build():
        args = server.get_parser().parse_args(flags)
        args.dilation = True
        model, _ = server.build_model(args, torch.device("cuda"))
        server.load_weights(model, ckpt, weights)
        return server.DetectionService("destr", model, C4_IMAGE, 0.0, letterbox=True)

    service, _, launches, timing, forward_ms = phase_serving(torch, kernels[0], seed, images, label=C4_LABEL,
                                                             build=build)
    worst = 0.0
    for image, record in zip(images, records):
        dets = service.predict_image(image)
        if record["labels"] != dets["labels"]:
            raise AssertionError("the CLI's labels or counts differ from the captured service's")
        for key in ("boxes", "scores"):
            worst = max(worst, float(np.abs(np.asarray(record[key], np.float32)
                                            - np.asarray(dets[key], np.float32)).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"the CLI's detections are {worst:.2e} from the captured service's")
    log(f"{C4_LABEL} serving: infer.cli --backbone resnet101 --dilation --image_size {C4_IMAGE}, one invocation a "
        f"request ({', '.join('x'.join(map(str, im.shape[:2])) for im in images)}), 18 #1 launches each, seconds "
        f"{', '.join(f'{t:.2f}' for t in cli_s)} (model build, checkpoint, PNG and forward); its detections within "
        f"{worst:.2e} of the captured service's")
    del service
    return {"cli_s": cli_s, "cli_worst": worst, "build_launches": launches, "forward_ms": forward_ms, **timing}


def c4_profile(torch, kernels, card):
    """tools/profile_step_torch.py at config 4: a captured step by category
    and kernel, and #1's and #2's device ms at each call site."""
    tool = repo_module("profile_step_torch", os.path.join("tools", "profile_step_torch.py"))
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build", "traces", "profile_step_c4")
    shutil.rmtree(trace_dir, ignore_errors=True)
    argv = ["--steps", str(PROFILE_STEPS), "--batch", "1", "--image", str(C4_IMAGE), "--backbone", "resnet101",
            "--dilation", "--top", "12", "--trace_dir", trace_dir]
    reset_counts(kernels)  # the profiled path starts here: a warm-up step, the capture, 3 replays
    out = _beside_card(card, "profile", tool.main, argv, phase=C4_LABEL)
    counts = [k.launches for k in kernels]
    per_step = [c / PROFILE_STEPS for c in trace_launches(out["trace"]["launches"])]
    busy, total = out["busy_ms_per_step"], out["total_ms_per_step"]
    if (per_step != [18.0, 18.0, 0.0, 0.0, 1.0, 0.0] or counts[:5] != [36, 36, 0, 0, 2]
            or not busy <= total <= (1 + PROFILE_OVERLAP) * busy):
        raise AssertionError(f"{C4_LABEL} profile: a step's #1/#2/#3/#4/#9/#8 {per_step}, wrapper launches "
                             f"{counts}, kernels {total} ms a step against busy {busy}")
    sites = flash_site_ms(trace_dir, PROFILE_STEPS)
    by_cat = {r["name"]: r for r in out["categories"]}
    flash = sum(r["ms_per_step"] for n, r in by_cat.items() if n.startswith("flash_attention"))
    shares = {"flash attention": flash / total,
              **{n: by_cat[n]["ms_per_step"] / total if n in by_cat else 0.0
                 for n in ("convolution", "GEMM", "elementwise / reduction", "copies and memsets")}}
    log(f"{C4_LABEL} profile ({card}): a replayed step's kernels sum to {total:.2f} ms against {busy:.2f} ms busy; "
        f"shares of the kernels' sum " + ", ".join(f"{k} {v * 100:.1f} %" for k, v in shares.items())
        + "; device ms a step by site " + "; ".join(
            f"{k} " + ", ".join(f"{site} {v:.4f}" for site, v in ms.items()) for k, ms in sites.items()))
    return {**{k: out[k] for k in ("step_busy_ms", "step_period_ms", "busy_ms_per_step", "total_ms_per_step",
                                   "categories", "top")}, "per_step": per_step, "launches": counts,
            "shares": shares, "sites": sites}


def phase_config4(torch, kernels, seed, card):
    """Phase 19: BASELINE.json's config 4 through the port's entry points
    (train, captured step, evaluator, CLI and service, profile)."""
    from object_detection_destr_tpu_torch.infer import evaluate
    from object_detection_destr_tpu_torch.train.driver import _eval_batch, _make_loaders
    from object_detection_destr_tpu_torch.train.steps import make_destr_eval_step

    t0 = time.perf_counter()
    seconds, last = {}, [t0]

    def lap(name):
        """The seconds since the previous lap, as ``name``'s."""
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    flash_cells, auction_cell = c4_kernels(torch, seed)
    lap("kernels")
    work = tempfile.mkdtemp(prefix="chip_smoke_c4_",
                            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build"))
    try:
        state, counts, step_ms, record = phase_train(torch, kernels, seed, C4_ARGS, C4_PER_STEP, C4_LABEL,
                                                     checkpoints=work, valid=C4_VALID)
        if record is None or not math.isfinite(record["mAP"]):
            raise AssertionError(f"{C4_LABEL}: no finite validation record: {record}")
        parts = step_parts(torch, state, train_batch(torch, 1, seed, out_size=C4_IMAGE), recipe_train_config(C4_ARGS))
        log(f"train {C4_LABEL}: where a step of make_destr_train_step goes, ms (CUDA events, median of 3) "
            + " ".join(f"{k}={v:.2f}" for k, v in parts.items())
            + f" rest={parts['step'] - sum(v for k, v in parts.items() if k != 'step'):.2f}")
        # the evaluator on the step's checkpoint, and the trainer's eval step on one batch
        base = TRAIN_ARGS + C4_ARGS + ["--seed", str(seed), "--num_valid_samples", str(C4_VALID),
                                       "--checkpoint_dir", work]
        reset_counts(kernels)
        start = time.perf_counter()
        evaluated = evaluate.main(base + ["--resume_from", "train"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - start
        eval_counts = [k.launches for k in kernels]
        if (abs(evaluated["map"] - record["mAP"]) > 1e-6 or evaluated["n_images"] != C4_VALID
                or eval_counts != [18 * EVAL_CAPTURE_CALLS] + [0] * 8):
            raise AssertionError(f"evaluate {C4_LABEL}: map {evaluated['map']} over {evaluated['n_images']} images "
                                 f"with launches {eval_counts}, the driver's mAP {record['mAP']}")
        config = recipe_config(C4_ARGS + ["--num_valid_samples", str(C4_VALID)])
        raw = next(iter(_make_loaders(config, C4_CANVAS, "destr")[1]))
        batch = _eval_batch(raw, torch.device("cuda"), C4_CANVAS, C4_IMAGE)
        eval_step = make_destr_eval_step(config.train)
        eval_ms = time_cuda(torch, lambda: eval_step(state, batch))
        size_mb = os.path.getsize(os.path.join(work, "train")) / 1e6
        log(f"{C4_LABEL} validation: the driver's sweep of {C4_VALID} images mAP={record['mAP']:.6f}; infer.evaluate "
            f"--backbone resnet101 --dilation --image_size {C4_IMAGE} on its checkpoint ({size_mb:.1f} MB) "
            f"map={evaluated['map']:.6f} in {eval_s:.1f} s (host clock, model build and checkpoint read inside), "
            f"launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {eval_counts} (18 #1 in the captured forward's warm-up and "
            f"capture); the trainer's eval step "
            f"{eval_ms:.2f} ms a batch of 1 (CUDA events, matcher and losses inside)")
        del state, batch, raw
        torch.cuda.empty_cache()
        lap("train, validate")
        captured = phase_captured_train(torch, kernels, destr_capture_setup(torch, seed, C4_ARGS), C4_PER_STEP[:6],
                                        C4_LABEL, eager_runs=3)
        torch.cuda.empty_cache()
        lap("captured")
        served = c4_serving(torch, kernels, seed, work, "train")
        torch.cuda.empty_cache()
        lap("serve")
        profile = c4_profile(torch, kernels, card)
        torch.cuda.empty_cache()
        lap("profile")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"flash_cells": flash_cells, "auction": auction_cell, "counts": counts, "step_ms": step_ms,
           "parts": parts, "map": record["mAP"], "eval_counts": eval_counts, "eval_s": eval_s, "eval_ms": eval_ms,
           "checkpoint_mb": size_mb,
           "captured": {k: v for k, v in captured.items() if k != "spread"}, "serving": served, "profile": profile,
           "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    log(f"{C4_LABEL} ({card}): eager step median {step_ms:.2f} ms ({1e3 / step_ms:.2f} images/s), captured step "
        f"{captured['captured_ms']:.2f} ms ({1e3 / captured['captured_ms']:.2f} images/s; eager "
        f"{captured['eager_ms']:.2f}), captured busy {captured['captured_step_busy_ms']:.2f} ms, idle share "
        f"{captured['captured_idle_share']:.4f}, peak above the state: eager step "
        f"{captured['eager_step_peak_gb']:.2f} GB, warm-up and capture {captured['captured_peak_gb']:.2f} GB; "
        f"request captured {served['captured_ms']:.2f} ms (eager {served['eager_ms']:.2f}, idle "
        f"{served['captured_idle_share']:.4f}); flash share of a replayed step "
        f"{profile['shares']['flash attention'] * 100:.1f} %; phase {out['seconds']:.1f} s, by part "
        f"{json.dumps(_rounded(seconds))}")
    return out


# ---- slice 16: BASELINE.json's config 2 (DESTR-R50 over COCO's 80 classes at 800 px)
C2_LABEL = "coco-800"
C2_IMAGE = 800
C2_CANVAS = int(C2_IMAGE * 672 / 640)  # 840, the trainer's canvas
C2_B = 8  # bench.py's batch in BENCH_MODE=infer
C2_NUM_CLS = 81  # COCO's 80 classes and the background channel
C2_TOKENS = 25 * 25  # C5 at stride 32: 800 -> 400 -> 200 -> 100 -> 50 -> 25
C2_TRAIN_IMAGES = C2_B * TRAIN_STEPS  # one epoch of 4 steps
C2_VALID_IMAGES = 2 * C2_B  # two validation batches
# COCO's 80 category ids: 1-90 without the 10 that its annotations never use
COCO_CATEGORY_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
COCO_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500), (640, 427)]  # (H, W): COCO's common sizes
C2_SITES = [("encoder_self_625", C2_TOKENS, C2_TOKENS, 8, 32, 32, True), SITES[1],
            ("cross_cls_reg_625", 600, C2_TOKENS, 1, 512, 256, True)]
C2_PER_STEP = (18, 18, 0, 0, 1, 0, 0, 0, 0)
# the CLI (one float32 forward at B=8) against the captured service (B=1):
# cuDNN picks its convolution algorithms by batch size, so the two sum in
# other orders; where the forward makes the same discrete choices their
# detections were 6.6e-7 apart at most (boxes and scores; H100 80GB HBM3,
# PERF.md), and near ties may make other choices (c2_cli_against_service)
C2_CLI_TOL = 1e-4
C2_NEAR_TIE = 1e-4  # the largest margin (score, IoU or size gap) of a choice that B=8 and B=1 make differently
JAX_C2_IMAGES_PER_SEC = 392.9  # BASELINE.md l.509: JAX's jitted B=8 bf16 forward on a TPU v5e at num_cls 2
SERVE_BUDGET_MS = 50.0  # the 640 px request budget (PERF.md §2)


def c2_args(root):
    """Config 2's flags on the COCO-layout tree at ``root``, after
    TRAIN_ARGS (whose synthetic flags they override or leave unused)."""
    return ["--dataset", "coco", "--data_root", root, "--num_cls", str(C2_NUM_CLS), "--image_size",
            str(C2_IMAGE), "--batch_size", str(C2_B), "--coco_eval"]


def write_coco_tree(root, seed, n_train=C2_TRAIN_IMAGES, n_valid=C2_VALID_IMAGES, sizes=COCO_SIZES, quality=90):
    """A COCO 2017 tree in the reader's layout: ``annotations/instances_
    {train,val}2017.json`` with COCO's 80 category ids and, under
    ``{train,val}2017/``, seeded JPEGs of ``sizes`` (H, W) in turn, each a
    smooth coloured background with 1-20 bright boxes; the boxes' classes
    run through a seeded permutation of the 80 in turn, so a split with 80
    boxes or more holds every class. Every fourth image also carries a crowd
    annotation and a zero-width one, which the reader skips. Returns
    {split: (images, boxes the reader keeps)}."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    categories = [{"id": c, "name": f"category_{c}", "supercategory": "object"} for c in COCO_CATEGORY_IDS]
    out = {}
    for split, n in (("train2017", n_train), ("val2017", n_valid)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        order = rng.permutation(len(COCO_CATEGORY_IDS))
        images, annotations, kept = [], [], 0

        def annotate(image_id, box, category, crowd=0):
            annotations.append({"id": len(annotations) + 1, "image_id": image_id, "category_id": int(category),
                                "bbox": [round(float(v), 2) for v in box], "area": float(box[2] * box[3]),
                                "iscrowd": crowd})

        for i in range(n):
            h, w = sizes[i % len(sizes)]
            image_id = i + 1
            coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
            image = np.array(Image.fromarray(coarse).resize((w, h), Image.BILINEAR))
            for _ in range(int(rng.integers(1, 21))):
                bw, bh = rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                image[int(y):int(y + bh), int(x):int(x + bw)] = rng.integers(100, 256, 3)
                annotate(image_id, (x, y, bw, bh), COCO_CATEGORY_IDS[order[kept % len(order)]])
                kept += 1
            if i % 4 == 0:
                annotate(image_id, (0, 0, w, h), COCO_CATEGORY_IDS[0], crowd=1)
                annotate(image_id, (w / 3, h / 3, 0, h / 4), COCO_CATEGORY_IDS[1])
            name = f"{image_id:012d}.jpg"
            Image.fromarray(image).save(os.path.join(root, split, name), quality=quality)
            images.append({"id": image_id, "file_name": name, "width": w, "height": h})
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
        out[split] = (n, kept)
    return out


def c2_kernels(torch, seed):
    """The kernels at config 2's shapes against their plain versions: #1 at
    the step's three sites in bfloat16 at B=8 and in float32 at B=1 and B=8
    (dropout 0, masked as on the path; device ms from CUDA-graph replay);
    #1 and the plan's backward (#2) at the three sites at B=8, bfloat16,
    dropout 0.3 (eager calls); #9 at C = 81 on a step's 16 problems of N =
    625 rows (the 300 queries padded to the tokens, then the tokens), 1-20
    valid targets each over all 80 classes: rows, rounds and bids equal to
    the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    forward = [flash_cell(torch, gen, site, b, dtype, 0.0, site[-1], None, True)
               for site in C2_SITES for dtype, b in ((torch.bfloat16, C2_B), (torch.float32, 1), (torch.float32, C2_B))]
    step = [flash_cell(torch, gen, site, C2_B, torch.bfloat16, RATE, site[-1], "plan", False) for site in C2_SITES]
    if not all(r["ok"] for r in forward + step) or not all(r["bwd_plan"] == "fused" for r in step):
        raise AssertionError(f"{C2_LABEL}: flash cells out of tolerance or off #2: "
                             f"{[r for r in forward + step if not r['ok'] or r.get('bwd_plan') not in (None, 'fused')]}")
    args = auction_problems(torch, seed, False, half=C2_B, n=C2_TOKENS, num_cls=C2_NUM_CLS)
    labels, valid = args[3], args[4]
    classes = int(labels[valid].unique().numel())
    if classes != C2_NUM_CLS - 1:
        raise AssertionError(f"{C2_LABEL} #9: the valid targets hold {classes} classes, not {C2_NUM_CLS - 1}")
    auction = {**fused_auction_cell(torch, C2_LABEL, args), "classes": classes, "valid_targets": valid.sum(1).tolist(),
               "max_abs_err": 0.0}
    log(f"{C2_LABEL} #9 at C={C2_NUM_CLS}: {2 * C2_B} problems N={C2_TOKENS} T=300, valid targets "
        f"{auction['valid_targets']} over {classes} classes: rows, rounds {auction['rounds']} and bids "
        f"{auction['bids']} equal to the plain version's; ms={auction['ms']:.4f} (eager call) kernel_device_ms="
        f"{auction['kernel_device_ms']:.4f} plain_ms={auction['plain_ms']:.2f} bound_ms={auction['bound_ms']:.6f} "
        f"({auction['bound_by']})")
    return forward, step, auction


def _match_detections(ours, theirs):
    """Match each detection of ``ours`` to the nearest free one of
    ``theirs`` with the same label (the largest absolute gap of box and
    score; near-equal scores may sort in another order). Returns each
    match's gap, np.inf where no free detection has the label."""
    import numpy as np

    if len(ours["labels"]) != len(theirs["labels"]):
        raise AssertionError(f"{len(ours['labels'])} detections against {len(theirs['labels'])}")
    rows = np.concatenate([np.asarray(theirs["boxes"], np.float64), np.asarray(theirs["scores"], np.float64)[:, None]], 1)
    labels = np.asarray(theirs["labels"])
    free = np.ones(len(labels), bool)
    gaps = []
    for box, score, label in zip(ours["boxes"], ours["scores"], ours["labels"]):
        gap = np.abs(rows - np.asarray(list(box) + [score], np.float64)).max(1)
        gap[~free | (labels != label)] = np.inf
        j = int(gap.argmin())
        free[j] = not np.isfinite(gap[j])
        gaps.append(float(gap[j]))
    return np.asarray(gaps)


def _dets_of(dets, i):
    """Image ``i``'s kept detections of a predict_arrays result, as lists."""
    keep = dets["valid"][i]
    return {"boxes": dets["boxes"][i][keep].tolist(), "scores": dets["scores"][i][keep].tolist(),
            "labels": dets["labels"][i][keep].tolist()}


def _choices_differ(torch, batch_record, alone_record, i):
    """Image ``i``'s choices in a forward of its own (``alone_record``)
    against its row of the batch's (``batch_record``), up to the order of
    the top-k tokens (the decoder is equivariant to it): [(kind, margin)]
    of those that differ, the top-k token set or else each block's pairs
    compared token by token, with margins on the B=1 run's values
    (choice_margin)."""
    (kind8, _, top8), (kind1, args1, top1) = batch_record[0], alone_record[0]
    if kind8 != "topk" or kind1 != "topk" or len(batch_record) != len(alone_record):
        raise AssertionError(f"the forwards' choices: {[r[0] for r in batch_record]} / {[r[0] for r in alone_record]}")
    top8 = top8[i:i + 1]
    if not torch.equal(top8.sort(1).values, top1.sort(1).values):
        return [("topk", choice_margin(torch, "topk", (args1, top1), top8))]
    n, k = args1[0].shape[1], top1.shape[1]
    pos8 = torch.full((n,), -1, dtype=torch.long, device=top1.device)
    pos1 = pos8.clone()
    pos8[top8[0]] = torch.arange(k, device=top1.device)
    pos1[top1[0]] = torch.arange(k, device=top1.device)
    differ = []
    for (_, _, pairs8), (kind, args, pairs1) in zip(batch_record[1:], alone_record[1:]):
        # the batch's pairs in this run's query order: query q holds token top1[q], the batch's row pos8[top1[q]]
        mapped = pos1[top8[0][pairs8[i][pos8[top1[0]]]]][None]
        if not torch.equal(mapped, pairs1):
            differ.append((kind, choice_margin(torch, kind, (args, pairs1), mapped)))
    return differ


def c2_cli_against_service(torch, model, images, records, served):
    """Hold the CLI's detections (``records``, one B=8 float32 forward) to
    the captured service's (``served``, B=1 each) image by image. The
    forward makes discrete choices (the mini-detector's top-k tokens, each
    decoder block's pairs) on float32 values that the two batch sizes sum
    in other orders (cuDNN picks its algorithms by batch size), so a near
    tie may fall either way and move detections past any float tolerance.
    So the CLI's own function (predict_arrays) runs the batch on the
    service's ``model`` with its choices recorded (its detections within
    C2_CLI_TOL of the CLI's), and each image alone (B=1) with its choices
    recorded (within C2_CLI_TOL of the service's). Where an image's choices
    equal the batch's (up to the top-k tokens' order, _choices_differ), the
    CLI's detections must match the service's (labels equal, boxes and
    scores within C2_CLI_TOL); where they differ, the first choice that
    differs (in the forward's order: the later ones are taken on values
    that it changed) must be a near tie, its margin on the B=1 run's values
    at most C2_NEAR_TIE, and the CLI's detections must match, within
    C2_CLI_TOL, the image run alone with the batch's choices replayed.
    Returns the gaps and the flips."""
    import numpy as np

    from object_detection_destr_tpu_torch.infer.cli import predict_arrays

    batch_record = []
    with choices(record=batch_record):
        batch = predict_arrays(model, "destr", images, C2_IMAGE, 0.0)
    gaps = {"cli_vs_batch": 0.0, "alone_vs_service": 0.0, "cli_vs_service": [], "cli_vs_replayed": []}
    flips = {}
    for i, (image, record, service_dets) in enumerate(zip(images, records, served)):
        gaps["cli_vs_batch"] = max(gaps["cli_vs_batch"], float(_match_detections(record, _dets_of(batch, i)).max()))
        alone_record = []
        with choices(record=alone_record):
            alone = predict_arrays(model, "destr", [image], C2_IMAGE, 0.0)
        gaps["alone_vs_service"] = max(gaps["alone_vs_service"],
                                       float(_match_detections(_dets_of(alone, 0), service_dets).max()))
        differ = _choices_differ(torch, batch_record, alone_record, i)
        service_gap = float(_match_detections(record, service_dets).max())
        if not differ:
            gaps["cli_vs_service"].append(service_gap)
            continue
        flips[i] = {"choices": differ, "cli_vs_service": service_gap}
        with choices(replay=[(kind, None, out[i:i + 1]) for kind, _, out in batch_record]):
            replayed = predict_arrays(model, "destr", [image], C2_IMAGE, 0.0)
        gaps["cli_vs_replayed"].append(float(_match_detections(record, _dets_of(replayed, 0)).max()))
    held = [gaps["cli_vs_batch"], gaps["alone_vs_service"], *gaps["cli_vs_service"], *gaps["cli_vs_replayed"]]
    if not (np.isfinite(held).all() and max(held) <= C2_CLI_TOL) or any(
            flip["choices"][0][1] > C2_NEAR_TIE for flip in flips.values()):
        raise AssertionError(f"{C2_LABEL}: the CLI's detections against the service's: gaps {gaps}, choices of the "
                             f"batch and of an image alone that differ, with their margins, {flips}")
    return gaps, flips


def c2_evaluate(torch, kernels, base, record, ckpt):
    """infer.evaluate on the step's checkpoint (map and coco_map within 1e-6
    of the trainer's sweep; 18 #1 launches in its captured forward's warm-up
    and capture, one greedy-match launch a batch and metric), then the
    sweep's parts on the same checkpoint and split: the loader's host decode
    and letterbox (canvas 840), the eval transform on the device (840 ->
    800), the model's forward as the evaluator runs it, eager and captured
    (CUDA events), the two metrics' update on the device (host clock to a
    synchronize; COCO's with its one copy to the host) and compute, and the
    trainer's sweep (driver._val_sweep with the captured eval step) run
    twice on the split, the second time on the captured graph."""
    from object_detection_destr_tpu_torch.infer import evaluate
    from object_detection_destr_tpu_torch.losses.metrics import CocoAveragePrecision, MeanAveragePrecision
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference
    from object_detection_destr_tpu_torch.train.driver import _eval_batch, _make_loaders, _val_sweep
    from object_detection_destr_tpu_torch.train.state import TrainState
    from object_detection_destr_tpu_torch.train.steps import CapturedEvalStep, make_destr_eval_step

    reset_counts(kernels)
    start = time.perf_counter()
    evaluated = evaluate.main(base + ["--resume_from", "train"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - start
    counts = [k.launches for k in kernels]
    greedy = greedy_kernel().launches
    batches = C2_VALID_IMAGES // C2_B
    if (abs(evaluated["map"] - record["mAP"]) > 1e-6 or abs(evaluated["coco_map"] - record["coco_mAP"]) > 1e-6
            or evaluated["n_images"] != C2_VALID_IMAGES or counts != [18 * EVAL_CAPTURE_CALLS] + [0] * 8
            or greedy != 2 * batches):
        raise AssertionError(f"evaluate {C2_LABEL}: map {evaluated['map']} coco_map {evaluated['coco_map']} over "
                             f"{evaluated['n_images']} images with launches {counts} and {greedy} greedy matches, "
                             f"the trainer's mAP {record['mAP']} coco_mAP {record['coco_mAP']}")
    config = recipe_config(base)
    valid_loader = _make_loaders(config, C2_CANVAS, "destr")[1]
    t0 = time.perf_counter()
    raws = list(valid_loader)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(raws)
    device = torch.device("cuda")
    transform_ms = time_cuda(torch, lambda: _eval_batch(raws[0], device, C2_CANVAS, C2_IMAGE))
    model = build_destr(config.destr, device)
    model.load_state_dict(restore_for_inference(ckpt, "train"))
    model.eval()
    state = TrainState(model=model, optimizer=None, rng=None)
    forward = CapturedEvalStep(lambda st, b: st.model(b["images"], b.get("pixel_valid"))[0])
    metric = MeanAveragePrecision(num_cls=1, num_pred=config.destr.top_k)
    coco = CocoAveragePrecision(num_cls=C2_NUM_CLS - 1)
    m_state, map_ms, coco_ms, forward_ms, captured_ms = metric.init_state(device), [], [], [], []
    with torch.no_grad():
        for raw in raws:
            batch = _eval_batch(raw, device, C2_CANVAS, C2_IMAGE)
            forward_ms.append(time_cuda(torch, lambda: model(batch["images"], batch.get("pixel_valid"))))
            captured_ms.append(time_cuda(torch, lambda: forward(state, batch)))
            outputs = forward(state, batch)
            targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m_state = metric.update(m_state, outputs, targets)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            coco.update(outputs, targets)
            t2 = time.perf_counter()
            map_ms.append((t1 - t0) * 1e3)
            coco_ms.append((t2 - t1) * 1e3)
    t0 = time.perf_counter()
    parts_map, parts_coco = metric.compute(m_state), coco.compute()
    compute_ms = (time.perf_counter() - t0) * 1e3
    if abs(parts_map - record["mAP"]) > 1e-6 or abs(parts_coco - record["coco_mAP"]) > 1e-6:
        raise AssertionError(f"{C2_LABEL}: the split sweep's map {parts_map} / coco_map {parts_coco} differ from the "
                             f"driver's {record['mAP']} / {record['coco_mAP']}")
    del forward
    # the trainer's sweep on this checkpoint: the first pass captures, the second replays
    eval_step = CapturedEvalStep(make_destr_eval_step(config.train))
    sweeps = [_val_sweep(state, _make_loaders(config, C2_CANVAS, "destr")[1], eval_step, metric, coco, device,
                         C2_CANVAS, C2_IMAGE) for _ in range(2)]
    if any(abs(sw[1] - record["mAP"]) > 1e-6 or abs(sw[2] - record["coco_mAP"]) > 1e-6 for sw in sweeps):
        raise AssertionError(f"{C2_LABEL}: the captured sweeps' map / coco_map {[sw[1:3] for sw in sweeps]} differ "
                             f"from the trainer's {record['mAP']} / {record['coco_mAP']}")
    sweep_s = record["seconds"][0]
    warm_s = sweeps[1][3]
    out = {"map": evaluated["map"], "coco_map": evaluated["coco_map"], "counts": counts, "greedy_launches": greedy,
           "eval_s": eval_s, "sweep_s": sweep_s, "sweep_images_per_sec": C2_VALID_IMAGES / sweep_s,
           "warm_sweep_s": warm_s, "warm_sweep_images_per_sec": C2_VALID_IMAGES / warm_s,
           "host_decode_letterbox_ms": host_ms, "eval_transform_ms": transform_ms,
           "forward_ms": statistics.median(forward_ms), "captured_forward_ms": statistics.median(captured_ms),
           "map_update_ms": statistics.median(map_ms), "coco_update_ms": statistics.median(coco_ms),
           "metrics_update_ms": statistics.median(a + b for a, b in zip(map_ms, coco_ms)),
           "metrics_compute_ms": compute_ms}
    log(f"{C2_LABEL} validation: the driver's sweep of {C2_VALID_IMAGES} COCO images (2 batches of {C2_B}) map="
        f"{record['mAP']:.6f} coco_map={record['coco_mAP']:.6f} in {sweep_s:.2f} s ({out['sweep_images_per_sec']:.1f} "
        f"images/s, host clock, the eval step's capture inside); the same sweep again on its graph {warm_s:.3f} s "
        f"({out['warm_sweep_images_per_sec']:.1f} images/s); infer.evaluate --dataset coco --num_cls {C2_NUM_CLS} "
        f"--image_size {C2_IMAGE} --batch_size {C2_B} --compute_dtype bfloat16 on its checkpoint "
        f"map={evaluated['map']:.6f} coco_map={evaluated['coco_map']:.6f} in {eval_s:.1f} s (model build and "
        f"checkpoint read inside), launches #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts} (18 #1 in the captured forward's "
        f"warm-up and capture), greedy match {greedy}; a batch's parts: host decode and letterbox to {C2_CANVAS} "
        f"{host_ms:.2f} ms (the loader, host clock), eval transform {C2_CANVAS} -> {C2_IMAGE} {transform_ms:.2f} ms, "
        f"forward {out['forward_ms']:.2f} ms eager, {out['captured_forward_ms']:.2f} ms captured (CUDA events), "
        f"the reference mAP update {out['map_update_ms']:.2f} ms and COCO AP over {C2_NUM_CLS - 1} classes "
        f"{out['coco_update_ms']:.2f} ms a batch (on the device, host clock to a synchronize; COCO's one copy to the "
        f"host inside), compute {compute_ms:.2f} ms")
    del model, state, eval_step
    torch.cuda.empty_cache()
    return out


def c2_cli_and_service(torch, kernels, seed, ckpt, files):
    """infer.cli --num_cls 81 --image_size 800 on the 8 ``files`` in one
    invocation (one float32 forward at B=8: 18 #1 launches in all),
    letterboxed and then with --no-letterbox; phase 8's serving on a
    captured DetectionService that infer.server.build_service builds from
    the same flags, its requests 4 of the images (four aspects) twice; each
    image's letterboxed CLI detections held to the service's
    (c2_cli_against_service)."""
    from object_detection_destr_tpu_torch.infer import cli

    flags = ["--checkpoint_dir", ckpt, "--weights", "train", "--score_thresh", "0.0", "--num_cls", str(C2_NUM_CLS),
             "--image_size", str(C2_IMAGE)]
    runs = {}
    for name, extra in (("letterbox", []), ("stretch", ["--no-letterbox"])):
        reset_counts(kernels)  # one invocation of the CLI starts here
        t0 = time.perf_counter()
        records = cli.main(flags + extra + ["--images", *files, "--output", os.path.join(ckpt, f"dets_{name}.json")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        if counts != [3 * BLOCKS] + [0] * 8:
            raise AssertionError(f"cli {name}: #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}, not 18 #1 for {len(files)} images")
        for r in records:
            if (len(r["scores"]) != 300 or not all(0 <= label < C2_NUM_CLS - 1 for label in r["labels"])
                    or not all(0.0 <= c <= 1.0 for box in r["boxes"] for c in box)):
                raise AssertionError(f"cli {name}: {len(r['scores'])} detections or labels / boxes out of range")
        runs[name] = {"records": records, "seconds": seconds, "counts": counts,
                      "classes": len({label for r in records for label in r["labels"]})}
    images = [cli._load_image(f) for f in files]
    aspects = [images[i] for i in (0, 1, 2, 4)]  # 480x640, 640x480, 427x640, 640x427
    service, _, launches, timing, forward_ms = phase_serving(torch, kernels[0], seed, aspects,
                                                             service_args=flags, label=C2_LABEL)
    served = [service.predict_image(image) for image in images]
    gaps, flips = c2_cli_against_service(torch, service.model, images, runs["letterbox"]["records"], served)
    del service
    torch.cuda.empty_cache()
    worst = max(gaps["cli_vs_service"] + gaps["cli_vs_replayed"])
    fmt = lambda values: "[" + ", ".join(f"{v:.3e}" for v in values) + "]"  # noqa: E731
    flipped = "; ".join(f"image {i}: " + ", ".join(f"{kind} margin {margin:.3e}" for kind, margin in f["choices"])
                        + f", against the service {f['cli_vs_service']:.3e}" for i, f in flips.items())
    log(f"{C2_LABEL} cli against the service (largest gap of boxes and scores, labels equal): the CLI against "
        f"predict_arrays at B={len(files)} on the service's model {gaps['cli_vs_batch']:.3e}, an image alone (B=1, "
        f"eager) against the captured service {gaps['alone_vs_service']:.3e}; the CLI against the service on the "
        f"{len(gaps['cli_vs_service'])} images whose forward makes the batch's choices {fmt(gaps['cli_vs_service'])} "
        f"(tolerance {C2_CLI_TOL:g}); images whose top-k tokens or pairs differ from the batch's, the first at a near "
        f"tie (at most {C2_NEAR_TIE:g}), with each differing choice's margin: {flipped or 'none'}; the CLI against those images alone with the batch's choices "
        f"replayed {fmt(gaps['cli_vs_replayed'])}")
    log(f"{C2_LABEL} cli: infer.cli --num_cls {C2_NUM_CLS} --image_size {C2_IMAGE} on {len(files)} COCO images "
        f"({', '.join('x'.join(map(str, im.shape[:2])) for im in images)}) in one invocation: letterboxed "
        f"{runs['letterbox']['seconds']:.2f} s, --no-letterbox {runs['stretch']['seconds']:.2f} s (model build, "
        f"checkpoint, decode and one B={len(files)} float32 forward), 18 #1 launches each, 300 detections an image "
        f"over {runs['letterbox']['classes']} labels; request median {timing['captured_ms']:.2f} ms captured (eager "
        f"{timing['eager_ms']:.2f}, idle {timing['captured_idle_share']:.4f}) beside the {SERVE_BUDGET_MS:g} ms "
        f"budget of a 640 px request")
    return {"cli_s": {k: v["seconds"] for k, v in runs.items()}, "cli_counts": runs["letterbox"]["counts"],
            "cli_worst": worst, "cli_classes": runs["letterbox"]["classes"],
            "gaps": gaps, "flips": {i: f["choices"] for i, f in flips.items()},
            "build_launches": launches, "forward_ms": forward_ms, **timing}


def c2_batched_forward(torch, kernels, ckpt, files):
    """bench.py's infer mode (BENCH_MODE=infer BENCH_IMAGE=800, bench.py:
    205-231) on the port: the model's forward at B=8, 800 px, bfloat16
    autocast, eval mode (train=False), on 8 letterboxed images with their
    pixel masks, from the step's checkpoint; eager (18 #1 launches a
    forward) and replayed as a CUDA graph captured here (its outputs within
    1e-4 of the eager ones' largest value): CUDA-event ms a batch in turns
    (E C C E, 5 each), a traced window of 3 forwards of each (busy ms, idle
    share, 18 #1 a forward from the trace) and the peak memory an eager
    forward adds to its weights and inputs."""
    import numpy as np

    from object_detection_destr_tpu_torch.config import DestrConfig
    from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas
    from object_detection_destr_tpu_torch.data.transforms import letterbox_infer_transform
    from object_detection_destr_tpu_torch.infer.cli import _load_image
    from object_detection_destr_tpu_torch.models.destr.model import build_destr
    from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference

    model = build_destr(DestrConfig(num_cls=C2_NUM_CLS, compute_dtype="bfloat16"), "cuda")
    model.load_state_dict(restore_for_inference(ckpt, "train"))
    model.eval()
    placed = [_letterbox_canvas(_load_image(f), C2_IMAGE) for f in files]
    prep = letterbox_infer_transform(torch.from_numpy(np.stack([c for c, _, _ in placed])).cuda(),
                                     torch.tensor([(fh, fw) for _, fh, fw in placed], dtype=torch.float32),
                                     out_size=C2_IMAGE)
    images, pixel_valid = prep["images"], prep["pixel_valid"]

    @torch.inference_mode()
    def forward():
        return model(images, valid_mask=pixel_valid)[0]

    reset_counts(kernels)  # the eager forward starts here
    eager_out = forward()
    torch.cuda.synchronize()
    eager_counts = [k.launches for k in kernels]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    forward()
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    reset_counts(kernels)  # the captured forward starts here: its warm-up on a side stream, then the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        forward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = forward()
    counts = [k.launches for k in kernels]
    graph.replay()
    torch.cuda.synchronize()
    gap = {k: (static[k] - eager_out[k]).abs().max().item() / max(eager_out[k].abs().max().item(), 1e-30)
           for k in ("pred_class", "pred_boxes")}
    if (eager_counts != [3 * BLOCKS] + [0] * 8 or counts != [6 * BLOCKS] + [0] * 8
            or static["pred_class"].shape != (C2_B, 300, C2_NUM_CLS)
            or not all(bool(torch.isfinite(v).all()) for v in static.values()) or not max(gap.values()) <= 1e-4):
        raise AssertionError(f"{C2_LABEL} forward: launches eager {eager_counts}, with the capture {counts}; "
                             f"pred_class {tuple(static['pred_class'].shape)}; replay against eager {gap}")
    run = {"eager": lambda: forward(), "captured": lambda: graph.replay()}
    times = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        events[0].record()
        for e in events[1:]:
            run[kind]()
            e.record()
        torch.cuda.synchronize()
        times[kind] += [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def window(kind):
        def run_steps(scope):
            for i in range(3):
                with scope(i):
                    run[kind]()
        return run_steps
    windows = {kind: traced(torch, f"forward_{C2_LABEL}_{kind}", 3, window(kind)) for kind in run}
    for kind, w in windows.items():
        if w["per_step"] != [3.0 * BLOCKS, 0, 0, 0, 0, 0]:
            raise AssertionError(f"{C2_LABEL} forward: a traced {kind} forward launched #1/#2/#3/#4/#9/#8 "
                                 f"{w['per_step']}")
    out = {"eager_ms": statistics.median(times["eager"]), "captured_ms": statistics.median(times["captured"]),
           "eager_ms_all": times["eager"], "captured_ms_all": times["captured"], "peak_gb": peak_gb,
           "launches": {"eager": eager_counts[0], "warm-up and capture": counts[0]}, "replay_rel_gap": gap,
           **{f"{kind}_{key}": w[key] for kind, w in windows.items()
              for key in ("idle_share", "step_busy_ms", "step_period_ms", "kernel_ms")}}
    out["images_per_sec"] = C2_B * 1e3 / out["captured_ms"]
    log(f"{C2_LABEL} forward (bench.py's infer mode: B={C2_B}, {C2_IMAGE} px, bfloat16, eval, letterbox pixel "
        f"masks): ms a batch (CUDA events, in turns E C C E, 5 each) eager {out['eager_ms']:.2f} "
        f"({C2_B * 1e3 / out['eager_ms']:.1f} images/s), captured {out['captured_ms']:.2f} "
        f"({out['images_per_sec']:.1f} images/s; all {', '.join(f'{t:.2f}' for t in times['captured'])}); traced 3 "
        f"forwards: eager busy {out['eager_step_busy_ms']:.2f} ms of {out['eager_step_period_ms']:.2f}, idle share "
        f"{out['eager_idle_share']:.4f}; captured busy {out['captured_step_busy_ms']:.2f} ms of "
        f"{out['captured_step_period_ms']:.2f}, idle share {out['captured_idle_share']:.4f}; #1 a forward "
        f"{out['captured_kernel_ms'][0]:.3f} ms (trace); peak memory an eager forward adds {peak_gb:.2f} GB; replay "
        f"against eager (relative) {json.dumps(_rounded(gap))}; JAX's figure of record {JAX_C2_IMAGES_PER_SEC} "
        f"images/s is a TPU v5e's at num_cls 2 (BASELINE.md), not the port's")
    del graph, model
    torch.cuda.empty_cache()
    return out


def phase_config2(torch, kernels, seed, card):
    """Phase 20: BASELINE.json's config 2 through the port's entry points
    on a COCO-layout tree (train with validation and COCO AP, captured
    step, evaluator, batch CLI, captured service, bench.py's batched bf16
    forward) and its kernels at the path's shapes."""
    t0 = time.perf_counter()
    seconds, last = {}, [t0]

    def lap(name):
        """The seconds since the previous lap, as ``name``'s."""
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    forward_cells, step_cells, auction_cell = c2_kernels(torch, seed)
    lap("kernels")
    work = tempfile.mkdtemp(prefix="chip_smoke_c2_",
                            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build"))
    try:
        from object_detection_destr_tpu_torch.data.datasets import CocoDetection

        root = os.path.join(work, "coco")
        written = write_coco_tree(root, seed)
        for split in ("train2017", "val2017"):
            reader = CocoDetection(root, split)
            classes = {int(c) for i in range(len(reader)) for c in reader[i][2]}
            if len(reader) != written[split][0] or len(classes) != C2_NUM_CLS - 1:
                raise AssertionError(f"{C2_LABEL}: the reader gives {len(reader)} {split} images over "
                                     f"{len(classes)} classes, the tree holds {written[split]}")
        log(f"{C2_LABEL}: COCO-layout tree {json.dumps(written)} (images, boxes kept) under {root}, "
            f"{len(COCO_CATEGORY_IDS)} category ids 1-90 with COCO's gaps; every split holds all 80 classes")
        lap("tree")
        extra = c2_args(root)
        state, counts, step_ms, record = phase_train(torch, kernels, seed, extra, C2_PER_STEP, C2_LABEL,
                                                     checkpoints=work, valid=C2_VALID_IMAGES)
        if record is None or not (math.isfinite(record["mAP"]) and math.isfinite(record["coco_mAP"])):
            raise AssertionError(f"{C2_LABEL}: no finite validation record: {record}")
        del state
        torch.cuda.empty_cache()
        lap("train, validate")
        base = TRAIN_ARGS + extra + ["--seed", str(seed), "--checkpoint_dir", work]
        evaluated = c2_evaluate(torch, kernels, base, record, work)
        lap("evaluate")
        captured = phase_captured_train(torch, kernels, destr_capture_setup(torch, seed, extra), C2_PER_STEP[:6],
                                        C2_LABEL, eager_runs=3)
        torch.cuda.empty_cache()
        lap("captured")
        files = [os.path.join(root, "val2017", f"{i + 1:012d}.jpg") for i in range(C2_B)]
        served = c2_cli_and_service(torch, kernels, seed, work, files)
        lap("cli, serve")
        batched = c2_batched_forward(torch, kernels, work, files)
        lap("forward")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"forward_cells": forward_cells, "step_cells": step_cells, "auction": auction_cell, "counts": counts,
           "step_ms": step_ms, "record": {k: record[k] for k in ("mAP", "coco_mAP", "seconds")},
           "evaluate": evaluated, "captured": {k: v for k, v in captured.items() if k != "spread"},
           "serving": served, "forward": batched, "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    log(f"{C2_LABEL} ({card}): train step eager median {step_ms:.2f} ms ({C2_B * 1e3 / step_ms:.1f} images/s), "
        f"captured {captured['captured_ms']:.2f} ms ({C2_B * 1e3 / captured['captured_ms']:.1f} images/s; eager "
        f"{captured['eager_ms']:.2f}), captured busy {captured['captured_step_busy_ms']:.2f} ms, idle share "
        f"{captured['captured_idle_share']:.4f}, peak above the state: eager step {captured['eager_step_peak_gb']:.2f} "
        f"GB, warm-up and capture {captured['captured_peak_gb']:.2f} GB; validation sweep "
        f"{evaluated['sweep_images_per_sec']:.1f} images/s with the capture, {evaluated['warm_sweep_images_per_sec']:.1f} "
        f"on the graph; request captured {served['captured_ms']:.2f} ms (eager "
        f"{served['eager_ms']:.2f}; the 640 px budget {SERVE_BUDGET_MS:g} ms); batched bf16 forward captured "
        f"{batched['captured_ms']:.2f} ms = {batched['images_per_sec']:.1f} images/s (eager {batched['eager_ms']:.2f}; "
        f"JAX's {JAX_C2_IMAGES_PER_SEC} images/s: TPU v5e, num_cls 2, not the port's); phase {out['seconds']:.1f} s, "
        f"by part {json.dumps(_rounded(seconds))}")
    return out


# ---- slice 17: BASELINE.json's config 1 (SSD300 over COCO's 80 classes)
C1_LABEL = "coco-ssd-300"
C1_NUM_CLS = 80  # COCO's classes; SSD's heads add the background channel (A x 81 confidences)
C1_B = 12  # the SSD trainer's default --batch_size (scripts/train_ssd_torch.sh passes no other)
C1_CANVAS = int(300 * 1.28)  # 384: the SSD trainer's and evaluator's canvas
C1_TRAIN_IMAGES = C1_B * TRAIN_STEPS  # one epoch of 4 steps
C1_VALID_IMAGES = 2 * C1_B  # two validation batches
C1_REQUESTS = 8  # the CLI's images in one invocation, and the service's requests
C1_CLI_TOL = 1e-5


def c1_args(root, seed, work):
    """Config 1's flags: the SSD trainer's defaults (B=12, 300 px, bf16,
    reference mining, lr 1e-5), COCO's 80 classes on the tree at ``root``,
    one epoch of its 4 batches, checkpoints in ``work``."""
    return ["--dataset", "coco", "--data_root", root, "--num_cls", str(C1_NUM_CLS), "--epochs", "1",
            "--augment_factor", "1", "--log_interval", "1", "--log_dir", "", "--seed", str(seed),
            "--checkpoint_dir", work, "--save_as", "c1"]


def c1_config(base):
    from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser

    return config_from_args(get_parser("ssd").parse_args(base), "ssd")


def no_launches(kernels, label):
    """Config 1's path launches none of the nine kernels: their counts, read
    after each part of the phase, stay 0."""
    counts = [k.launches for k in kernels]
    if counts != list(NO_LAUNCHES):
        raise AssertionError(f"{C1_LABEL} {label} launched #1/#2/#3/#4/#9/#8/#5/#6/#7 {counts}")


def c1_evaluate(torch, kernels, base, record, ckpt):
    """infer.evaluate --model ssd on the trainer's best checkpoint (map
    within 1e-6 of the trainer's sweep, the val loss within 1e-5 relative;
    one greedy-match launch a batch), then the sweep's parts on the same
    checkpoint and split: the loader's host decode and stretch to the canvas
    (384), the eval transform on the device (384 -> 300), the eval step
    (forward, criterion, decode) eager and captured (CUDA events),
    MeanAveragePrecision(num_cls=80)'s update on the device (host clock to a
    synchronize) and compute, and the trainer's sweep (driver._ssd_val_sweep
    with the captured eval step) run twice, the second on the graph."""
    from object_detection_destr_tpu_torch.data.transforms import ssd_eval_transform
    from object_detection_destr_tpu_torch.geometry.boxes import cxcyhw_to_xyxy
    from object_detection_destr_tpu_torch.infer import evaluate
    from object_detection_destr_tpu_torch.losses.metrics import MeanAveragePrecision
    from object_detection_destr_tpu_torch.models.ssd import build_ssd
    from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference
    from object_detection_destr_tpu_torch.train.driver import _make_loaders, _ssd_val_sweep, _to_device
    from object_detection_destr_tpu_torch.train.state import TrainState
    from object_detection_destr_tpu_torch.train.steps import CapturedEvalStep, make_ssd_eval_step

    reset_counts(kernels)
    start = time.perf_counter()
    evaluated = evaluate.main(["--model", "ssd"] + base + ["--resume_from", "c1"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - start
    no_launches(kernels, "evaluate")
    greedy = greedy_kernel().launches
    loss = record["valid"]["loss"]
    if (abs(evaluated["map"] - record["mAP"]) > 1e-6 or evaluated["n_images"] != C1_VALID_IMAGES
            or abs(evaluated["val_loss"] - loss) > 1e-5 * abs(loss) or greedy != C1_VALID_IMAGES // C1_B):
        raise AssertionError(f"evaluate {C1_LABEL}: {evaluated}, {greedy} greedy matches; the trainer's sweep {record}")
    config = c1_config(base)
    valid_loader = _make_loaders(config, C1_CANVAS, "ssd")[1]
    t0 = time.perf_counter()
    raws = list(valid_loader)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(raws)
    device = torch.device("cuda")
    batches = [_to_device(raw, device) for raw in raws]

    def transform(b):
        return ssd_eval_transform(b["images"], b["boxes"], b["labels"], b["valid"], out_size=config.ssd.image_size)
    transform_ms = time_cuda(torch, lambda: transform(batches[0]))
    model = build_ssd(config.ssd, device)
    model.load_state_dict(restore_for_inference(ckpt, "c1"))
    state = TrainState(model=model, optimizer=None, rng=None)
    eval_step = make_ssd_eval_step(config.train, config.ssd)
    captured = CapturedEvalStep(eval_step)
    metric = MeanAveragePrecision(num_cls=C1_NUM_CLS)
    m_state, update_ms, step_ms, captured_ms = metric.init_state(device), [], [], []
    for b in batches:
        batch = transform(b)
        step_ms.append(time_cuda(torch, lambda: eval_step(state, batch)))
        captured_ms.append(time_cuda(torch, lambda: captured(state, batch)))
        _, _, detections = captured(state, batch)
        targets = {"boxes": cxcyhw_to_xyxy(batch["boxes"]), "labels": batch["labels"], "valid": batch["valid"]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_state = metric.update(m_state, detections, targets)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    parts_map = metric.compute(m_state)
    compute_ms = (time.perf_counter() - t0) * 1e3
    sweeps = [_ssd_val_sweep(state, _make_loaders(config, C1_CANVAS, "ssd")[1], captured, metric, device,
                             config.ssd.image_size) for _ in range(2)]
    no_launches(kernels, "sweep parts")
    if abs(parts_map - record["mAP"]) > 1e-6 or any(abs(sw[1] - record["mAP"]) > 1e-6 for sw in sweeps):
        raise AssertionError(f"{C1_LABEL}: the split sweeps' map {parts_map}, {[sw[1] for sw in sweeps]} differ from "
                             f"the trainer's {record['mAP']}")
    sweep_s, warm_s = record["seconds"][0], sweeps[1][3]
    out = {"map": evaluated["map"], "val_loss": evaluated["val_loss"], "eval_s": eval_s, "sweep_s": sweep_s,
           "sweep_images_per_sec": C1_VALID_IMAGES / sweep_s, "warm_sweep_s": warm_s,
           "warm_sweep_images_per_sec": C1_VALID_IMAGES / warm_s, "host_decode_resize_ms": host_ms,
           "eval_transform_ms": transform_ms, "eval_step_ms": statistics.median(step_ms),
           "captured_eval_step_ms": statistics.median(captured_ms), "map_update_ms": statistics.median(update_ms),
           "map_compute_ms": compute_ms, "greedy_launches": greedy}
    log(f"{C1_LABEL} validation: the driver's sweep of {C1_VALID_IMAGES} COCO images (2 batches of {C1_B}) "
        f"mAP={record['mAP']:.6f} loss={loss:.4f} in {sweep_s:.3f} s ({out['sweep_images_per_sec']:.1f} images/s, host "
        f"clock, the eval step's capture inside); the same sweep again on its graph {warm_s:.3f} s "
        f"({out['warm_sweep_images_per_sec']:.1f} images/s); infer.evaluate --model ssd --dataset coco --num_cls "
        f"{C1_NUM_CLS} on its checkpoint map={evaluated['map']:.6f} val_loss={evaluated['val_loss']:.4f} in "
        f"{eval_s:.1f} s (model build and checkpoint read inside), greedy match {greedy}; a batch's parts: host "
        f"decode and stretch to {C1_CANVAS} {host_ms:.2f} ms (the loader, host clock), eval transform {C1_CANVAS} -> "
        f"300 {transform_ms:.3f} ms, eval step (forward, criterion, decode) {out['eval_step_ms']:.2f} ms eager, "
        f"{out['captured_eval_step_ms']:.2f} ms captured (CUDA events), MeanAveragePrecision over {C1_NUM_CLS} "
        f"classes update {out['map_update_ms']:.2f} ms a batch (on the device, host clock to a synchronize) and "
        f"compute {compute_ms:.2f} ms")
    del model, state, captured
    torch.cuda.empty_cache()
    return out


def c1_score_thresh(scores, n_images):
    """A score threshold for the CLI and the service, from the B=8
    forward's kept scores (one array an image, ``score_thresh`` 0): the
    middle of the widest gap between two neighbouring pooled scores such
    that every image keeps a detection and at most 25 an image are kept on
    average. A detection then lies no nearer the threshold than half that
    gap, so a float32 difference between the batched and the B=1 forward
    cannot move one across it. Returns (threshold, gap)."""
    import numpy as np

    pooled = np.sort(np.concatenate(scores))[::-1]
    floor = min(float(s.max()) for s in scores)  # every image keeps one above the threshold
    cuts = [k for k in range(1, len(pooled)) if pooled[k - 1] <= floor]
    cuts = [k for k in cuts if k <= max(25 * n_images, cuts[0])]
    gap, k = max((float(pooled[k - 1] - pooled[k]), k) for k in cuts)
    return float(pooled[k - 1] + pooled[k]) / 2, gap


def c1_cli_and_service(torch, kernels, seed, ckpt, files):
    """infer.cli --model ssd --num_cls 80 on the ``files`` in one invocation
    (one float32 forward at B=8), and phase 10's serving on a captured SSD
    DetectionService that infer.server.build_service builds from the same
    flags, its requests 4 of the images (four aspects) twice; each image's
    CLI detections held to the service's: the same number, each matched by
    one of the same label within 1e-5 (boxes and scores; cuDNN sums the
    B=8 and B=1 forwards in other orders). The score threshold of both
    (c1_score_thresh) is read off the CLI's own forward at threshold 0."""
    import numpy as np

    from object_detection_destr_tpu_torch.infer import cli
    from object_detection_destr_tpu_torch.infer.server import build_model, get_parser, load_weights

    images = [cli._load_image(f) for f in files]
    args = get_parser().parse_args(["--model", "ssd", "--checkpoint_dir", ckpt, "--weights", "c1", "--num_cls",
                                    str(C1_NUM_CLS)])
    model, size = build_model(args, torch.device("cuda"))
    load_weights(model, ckpt, "c1")
    dets = cli.predict_arrays(model, "ssd", images, size, score_thresh=0.0)
    thresh, gap = c1_score_thresh([dets["scores"][i][dets["valid"][i]] for i in range(len(images))], len(images))
    del model
    torch.cuda.empty_cache()
    flags = ["--checkpoint_dir", ckpt, "--weights", "c1", "--num_cls", str(C1_NUM_CLS), "--score_thresh", repr(thresh)]
    t0 = time.perf_counter()
    records = cli.main(["--model", "ssd", *flags, "--images", *files, "--output", os.path.join(ckpt, "dets.json")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    no_launches(kernels, "cli")
    aspects = [images[i] for i in (0, 1, 2, 4)]  # 480x640, 640x480, 427x640, 640x427
    service, timing = phase_ssd_serving(torch, kernels, seed, aspects, service_args=flags, label=f"{C1_LABEL} serving")
    served = [service.predict_image(image) for image in images]
    del service
    torch.cuda.empty_cache()
    worst = 0.0
    for f, rec, ref in zip(files, records, served):
        if not 0 < len(rec["boxes"]) == len(ref["boxes"]) or sorted(rec["labels"]) != sorted(ref["labels"]):
            raise AssertionError(f"{C1_LABEL} cli {f}: labels {rec['labels']}, the service's {ref['labels']}")
        rows = np.concatenate([np.asarray(ref["boxes"]), np.asarray(ref["scores"])[:, None]], 1)
        for box, score, label in zip(rec["boxes"], rec["scores"], rec["labels"]):
            gaps = np.abs(rows - np.asarray(box + [score])).max(1)
            gaps[np.asarray(ref["labels"]) != label] = np.inf
            if int((gaps <= C1_CLI_TOL).sum()) != 1:
                raise AssertionError(f"{C1_LABEL} cli {f}: detection {box} {score} {label} has "
                                     f"{int((gaps <= C1_CLI_TOL).sum())} matches in the service's within {C1_CLI_TOL}")
            worst = max(worst, float(gaps.min()))
    counts = [len(r["boxes"]) for r in records]
    log(f"{C1_LABEL} cli: infer.cli --model ssd --num_cls {C1_NUM_CLS} on {len(files)} COCO images "
        f"({', '.join('x'.join(map(str, im.shape[:2])) for im in images)}) in one invocation in {cli_s:.2f} s (model "
        f"build, checkpoint, decode and one B={len(files)} float32 forward), score threshold {thresh:.6f} (the widest "
        f"gap {gap:.3e} of the forward's scores), detections an image {counts} over "
        f"{len({c for r in records for c in r['labels']})} labels; each held to the captured service's (labels "
        f"equal, boxes and scores within {C1_CLI_TOL:g}): largest gap {worst:.3e}; request median "
        f"{timing['captured_ms']:.2f} ms captured (eager {timing['eager_ms']:.2f}, idle "
        f"{timing['captured_idle_share']:.4f})")
    return {"cli_s": cli_s, "score_thresh": thresh, "thresh_gap": gap, "cli_worst": worst, "detections": counts,
            **timing}


def phase_config1(torch, kernels, seed, card):
    """Phase 21: BASELINE.json's config 1 (SSD300 over COCO's 80 classes)
    through the port's entry points on a COCO-layout tree: train_ssd.main
    with the SSD trainer's defaults (4 steps and a validation sweep,
    checkpoints), the captured step held bit-equal to eager samples under
    deterministic cuDNN, the evaluator and the sweep's parts, the batch CLI
    against a captured service. SSD launches none of the nine kernels: their
    counts stay 0 through the phase."""
    from object_detection_destr_tpu_torch.data.datasets import CocoDetection
    from object_detection_destr_tpu_torch.train import train_ssd

    t0 = time.perf_counter()
    seconds, last = {}, [t0]

    def lap(name):
        """The seconds since the previous lap, as ``name``'s."""
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    work = tempfile.mkdtemp(prefix="chip_smoke_c1_",
                            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build"))
    reset_counts(kernels)  # the config-1 path starts here
    try:
        root = os.path.join(work, "coco")
        written = write_coco_tree(root, seed, n_train=C1_TRAIN_IMAGES, n_valid=C1_VALID_IMAGES)
        for split in ("train2017", "val2017"):
            reader = CocoDetection(root, split)
            classes = {int(c) for i in range(len(reader)) for c in reader[i][2]}
            if len(reader) != written[split][0] or len(classes) != C1_NUM_CLS:
                raise AssertionError(f"{C1_LABEL}: the reader gives {len(reader)} {split} images over "
                                     f"{len(classes)} classes, the tree holds {written[split]}")
        lap("tree")
        base = c1_args(root, seed, work)
        config = c1_config(base)
        cfg, ssd_cfg = config.train, config.ssd
        if (cfg.batch_size, ssd_cfg.image_size, ssd_cfg.compute_dtype, ssd_cfg.hard_neg_mining, cfg.lr) != (
                C1_B, 300, "bfloat16", "reference", 1e-5):
            raise AssertionError(f"{C1_LABEL}: the trainer's defaults changed: {cfg}, {ssd_cfg}")
        t1 = time.perf_counter()
        result = train_ssd.main(base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        no_launches(kernels, "train_ssd.main")
        state, record = result["state"], result["history"][0]
        files = sorted(f for f in os.listdir(work) if f.startswith("c1"))
        scalars = [record["mAP"], *record["valid"].values(), *result["metrics"].values()]
        if (state.step != TRAIN_STEPS or state.optimizer.count != TRAIN_STEPS or files != ["c1", "c1_last"]
                or not all(math.isfinite(v) for v in scalars)):
            raise AssertionError(f"{C1_LABEL}: {state.step} steps, {state.optimizer.count} updates, checkpoints "
                                 f"{files}, scalars {scalars}")
        step_ms = statistics.median(result["step_ms"][1:])
        log(f"{C1_LABEL}: COCO-layout tree {json.dumps(written)} (images, boxes kept), all 80 classes in each "
            f"split; train_ssd.main --dataset coco --num_cls {C1_NUM_CLS} (B={cfg.batch_size}, "
            f"{ssd_cfg.image_size} px, {ssd_cfg.compute_dtype}, {ssd_cfg.hard_neg_mining} mining, lr {cfg.lr:g}): "
            f"{state.step} steps and {C1_VALID_IMAGES} validation images in {wall:.1f} s, checkpoints {files}; last "
            f"losses " + " ".join(f"{k}={v:.4f}" for k, v in result["metrics"].items())
            + f"; mAP={record['mAP']:.6f} valid {record['valid']}; step ms (CUDA events) "
            + ", ".join(f"{t:.1f}" for t in result["step_ms"]) + f", median after the first {step_ms:.2f}")
        del state, result
        torch.cuda.empty_cache()
        lap("train, validate")
        captured = phase_captured_train(torch, kernels, ssd_capture_setup(torch, seed, config), NO_LAUNCHES,
                                        C1_LABEL, exact=True, eager_runs=3)
        no_launches(kernels, "captured step")
        torch.cuda.empty_cache()
        lap("captured")
        evaluated = c1_evaluate(torch, kernels, base, record, work)
        lap("evaluate")
        requests = [os.path.join(root, "val2017", f"{i + 1:012d}.jpg") for i in range(C1_REQUESTS)]
        served = c1_cli_and_service(torch, kernels, seed, work, requests)
        no_launches(kernels, "cli and serving")
        lap("cli, serve")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"step_ms": step_ms, "record": {k: record[k] for k in ("mAP", "valid", "seconds")},
           "captured": {k: v for k, v in captured.items() if k != "spread"}, "evaluate": evaluated,
           "serving": served, "launches": list(NO_LAUNCHES), "seconds": time.perf_counter() - t0,
           "seconds_by_part": seconds}
    log(f"{C1_LABEL} ({card}): train step eager median {step_ms:.2f} ms ({C1_B * 1e3 / step_ms:.1f} images/s), "
        f"captured {captured['captured_ms']:.2f} ms ({C1_B * 1e3 / captured['captured_ms']:.1f} images/s; eager "
        f"{captured['eager_ms']:.2f}), captured busy {captured['captured_step_busy_ms']:.2f} ms, idle share "
        f"{captured['captured_idle_share']:.4f}, peak above the state: eager step {captured['eager_step_peak_gb']:.2f} "
        f"GB, warm-up and capture {captured['captured_peak_gb']:.2f} GB; validation sweep "
        f"{evaluated['sweep_images_per_sec']:.1f} images/s with the capture, {evaluated['warm_sweep_images_per_sec']:.1f} "
        f"on the graph; request captured {served['captured_ms']:.2f} ms (eager "
        f"{served['eager_ms']:.2f}); launches of the nine kernels {list(NO_LAUNCHES)}; phase {out['seconds']:.1f} s, "
        f"by part {json.dumps(_rounded(seconds))}")
    return out


# ---- slice 18: validation as the JAX package runs it (the eval step captured, both metrics on the device)
V_LABEL = "validate-captured"
V_TRAIN_IMAGES = 24  # two steps of config 1's B=12, three of config 2's B=8
V_VALID_IMAGES = 24  # three validation batches of config 2, two of config 1
V_EAGER_RUNS = 3  # eager samples a captured one is held against with cuDNN's default engines
# the greedy walk at the path's launches: (cell, problems (B x C), ranks, targets, thresholds, COCO's rule)
GREEDY_CELLS = [("coco-800 COCO records", C2_B * (C2_NUM_CLS - 1), 100, 300, 10, True),
                ("coco-ssd-300 11-point", C1_B * C1_NUM_CLS, 300, 300, 1, False),
                ("destr 11-point", TRAIN_B, 300, 300, 1, False)]
GREEDY_SOURCE = f"{PKG}/csrc/greedy_match.cu"
# it replaces no pallas_call: the lax.scan of the JAX package's metrics
GREEDY_REPLACES = ("object_detection_destr_tpu/losses/metrics.py:83 (lax.scan in _update_one_class) and :276 "
                   "(lax.scan in _coco_batch_records); no pallas_call")


def greedy_inputs(torch, seed, p, r, t, skip):
    """One launch's operands on the card as the path makes them: per
    problem 0-20 valid targets of T (every 7th problem none; the other
    columns -1), IoUs on a 1/16 grid (ties, and every 9th rank's row at
    exactly 0.5), 60 % of them 0, every 37th rank's row NaN (a NaN forward);
    ``n_use`` all R ranks under COCO's rule, else 0-R (0 without a target)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_valid = torch.randint(0, 21, (p,), generator=gen, device="cuda")
    n_valid[::7] = 0
    valid = torch.arange(t, device="cuda")[None, :] < n_valid[:, None]
    iou = torch.randint(0, 17, (p, r, t), generator=gen, device="cuda").float() / 16
    iou = torch.where(torch.rand((p, r, t), generator=gen, device="cuda") < 0.6, 0.0, iou)
    iou[:, 4::9] = 0.5
    iou[:, 11::37] = float("nan")
    iou = torch.where(valid[:, None, :], iou, -1.0).contiguous()
    if skip:
        n_use = torch.full((p,), r, dtype=torch.int32, device="cuda")
    else:
        n_use = torch.randint(0, r + 1, (p,), generator=gen, device="cuda", dtype=torch.int32)
        n_use = torch.where(n_valid > 0, n_use, 0).to(torch.int32)
    return iou, n_use


def greedy_cell(torch, seed, label, p, r, t, j, skip):
    """The kernel against its plain version on one cell's operands: hits
    bit-equal; the kernel's device ms (CUDA-graph replay), the plain
    version's (eager, CUDA events) and the bound: the IoU rows the ranks in
    use read (4 bytes each), n_use and the (P, R, J) hits written, over HBM's
    rate, against one compare a (rank in use, target, threshold) over the
    float32 rate."""
    from object_detection_destr_tpu_torch.losses.metrics import CocoAveragePrecision
    from object_detection_destr_tpu_torch.ops.cuda.greedy_match import greedy_match_kernel, greedy_match_reference

    thresholds = list(CocoAveragePrecision.IOU_THRESHOLDS) if skip else [0.5]
    if len(thresholds) != j:
        raise AssertionError(f"greedy {label}: {len(thresholds)} thresholds, the cell says {j}")
    iou, n_use = greedy_inputs(torch, seed, p, r, t, skip)
    hits = greedy_match_kernel(iou, n_use, thresholds, skip)
    plain = greedy_match_reference(iou, n_use, thresholds, skip)
    torch.cuda.synchronize()
    if hits.shape != (p, r, j) or not torch.equal(hits, plain):
        raise AssertionError(f"greedy {label}: the kernel's hits differ from the plain version's in "
                             f"{int((hits != plain).sum())} of {plain.numel()}")
    ms = device_ms(torch, lambda: greedy_match_kernel(iou, n_use, thresholds, skip))
    plain_ms = time_cuda(torch, lambda: greedy_match_reference(iou, n_use, thresholds, skip), reps=3, warmup=1)
    used = int(n_use.clamp(max=r).sum())
    nbytes, ops = 4 * t * used + 4 * p + p * r * j, used * t * j
    bound_s = {"bytes": nbytes / HBM_RATE, "operations": ops / F32_PEAK}
    bound_by = max(bound_s, key=bound_s.get)
    cell = {"label": label, "problems": p, "ranks": r, "targets": t, "thresholds": j, "skip_matched": skip,
            "hits": int(hits.sum()), "ranks_used": used, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s[bound_by] * 1e3, "bound_by": bound_by, "max_abs_err": 0.0}
    log(f"greedy match {label}: P={p} R={r} T={t} J={j} {'COCO' if skip else '11-point'} rule, {used} ranks in "
        f"use, {cell['hits']} hits bit-equal to the plain version's; ms={ms:.4f} (device, CUDA graph) "
        f"plain_ms={plain_ms:.2f} (eager) bound_ms={cell['bound_ms']:.6f} ({bound_by}); no library call computes it")
    return cell


def synth_detections(seed, b, n, channels, t, classes):
    """Seeded outputs at a path's shapes with hits at every threshold: per
    image 1-20 valid targets of T over ``classes`` classes (the first image
    none), each prediction a jittered copy of a target whose class leads
    its logits, a duplicated box and score row; numpy (pred_class,
    pred_boxes cxcyhw, boxes xyxy, labels, valid)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.6, (b, t, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0.05, 0.35, (b, t, 2))], -1).astype(np.float32)
    valid = np.arange(t)[None, :] < rng.integers(1, 21, (b, 1))
    valid[0] = False
    labels = rng.integers(0, classes, (b, t)).astype(np.int32)
    src = rng.integers(0, 20, (b, n))
    rows = np.arange(b)[:, None]
    centre = (gt[rows, src, :2] + gt[rows, src, 2:]) / 2 + rng.normal(0, 0.02, (b, n, 2))
    size = (gt[rows, src, 2:] - gt[rows, src, :2]) * rng.uniform(0.8, 1.2, (b, n, 2))
    boxes = np.stack([centre[..., 0], centre[..., 1], size[..., 1], size[..., 0]], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]
    logits = rng.normal(0, 2, (b, n, channels)).astype(np.float32)
    logits[rows, np.arange(n)[None, :], labels[rows, src]] += 3.0
    logits[:, 3] = logits[:, 2]
    return {"pred_class": logits, "pred_boxes": np.clip(boxes, 0.0, 1.0)}, {"boxes": gt, "labels": labels,
                                                                            "valid": valid}


def metric_states_equal(torch, label, batches, metric, coco=None):
    """Both metrics over ``batches`` ((outputs, targets) on the card), on the
    card and as the plain version runs them on CPU copies: the 11-point
    state, COCO's hit records and ground-truth counts and both APs exactly
    equal, COCO's scores (sigmoids of the two devices' libraries) within
    1e-6 relative. Returns the card's update ms a batch (host clock to a
    synchronize; COCO's copy inside), mAP, COCO AP and the scores' gap."""
    import copy

    import numpy as np

    on = {"cuda": (metric.init_state("cuda"), copy.deepcopy(coco)), "cpu": (metric.init_state("cpu"),
                                                                          copy.deepcopy(coco))}
    warm = {k: v.cuda() for k, v in batches[0][0].items()}, {k: v.cuda() for k, v in batches[0][1].items()}
    metric.update(metric.init_state("cuda"), *warm)  # the first call's lazy kernel loads, untimed
    if coco is not None:
        copy.deepcopy(coco).update(*warm)
    update_ms = []
    for outputs, targets in batches:
        for dev, (state, c) in list(on.items()):
            o = {k: v.to(dev) for k, v in outputs.items()}
            tg = {k: v.to(dev) for k, v in targets.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = metric.update(state, o, tg)
            if c is not None:
                c.update(o, tg)
            torch.cuda.synchronize()
            if dev == "cuda":
                update_ms.append((time.perf_counter() - t0) * 1e3)
            on[dev] = (state, c)
    (dev_state, dev_coco), (cpu_state, cpu_coco) = on["cuda"], on["cpu"]
    if dev_state["tp"].device.type != "cuda":
        raise AssertionError(f"{label}: the 11-point state left the card")
    bad = [k for k in ("tp", "fp", "num_gts") if not torch.equal(dev_state[k].cpu(), cpu_state[k])]
    score_gap = 0.0
    if coco is not None:
        bad += ["coco _tp"] if not all(np.array_equal(a, b) for a, b in zip(dev_coco._tp, cpu_coco._tp)) else []
        bad += ["coco _num_gts"] if not np.array_equal(dev_coco._num_gts, cpu_coco._num_gts) else []
        # the scores are sigmoids of two devices' libraries: an ulp or two apart (1e-6 relative, as the CPU
        # tests hold the port's against JAX's); the hits they rank are exact
        score_gap = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
                        for a, b in zip(dev_coco._scores, cpu_coco._scores))
        bad += ["coco _scores"] if score_gap > 1e-6 else []
    ap = (metric.compute(dev_state), metric.compute(cpu_state))
    coco_ap = (dev_coco.compute(), cpu_coco.compute()) if coco is not None else (None, None)
    if bad or ap[0] != ap[1] or coco_ap[0] != coco_ap[1]:
        raise AssertionError(f"{label}: the card's metric states differ from the plain version's in {bad}; mAP "
                             f"{ap}, COCO AP {coco_ap}")
    return {"update_ms": statistics.median(update_ms), "map": ap[0], "coco_map": coco_ap[0],
            "tp": float(dev_state["tp"].sum()), "fp": float(dev_state["fp"].sum()), "coco_score_gap": score_gap}


def _cloned(x):
    """A nested return with every tensor cloned."""
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cloned(v) for v in x)
    return x.clone()


def _tensors(x):
    """The tensors of a nested return, in order."""
    if isinstance(x, dict):
        return [t for k in x for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [x]


def _sample(torch, out):
    """An eval step's return as a spread sample: its losses and its outputs."""
    tensors = _tensors(out)
    scalars = [t.detach().float().reshape(1) for t in tensors if t.numel() == 1]
    return {"losses": torch.cat(scalars), "outputs": torch.cat([t.detach().float().reshape(-1)
                                                                for t in tensors if t.numel() > 1])}


def v_hold(torch, label, state, eager_step, batches, sweep, train_two_steps, work):
    """The captured eval step against the eager one on one model:
    (1) under deterministic cuDNN, every batch's outputs and losses
    bit-equal; (2) with cuDNN's default engines, a captured batch within the
    spread of V_EAGER_RUNS eager ones (_hold_to_spread); (3) under
    deterministic cuDNN, the trainer's sweep captured and eager equal (loss
    means, mAP, COCO AP), then again after two train steps (the means must
    move), with an EMA swapped in by copy, and after the checkpoint of the
    first sweep's weights restored (equal to the first sweep): one graph,
    which reads the live weights. ``sweep(step)`` runs the trainer's sweep
    with ``step``; ``train_two_steps()`` trains. Returns the captured steps,
    times and checks."""
    from object_detection_destr_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from object_detection_destr_tpu_torch.train.driver import _make_ema, _parameters_swapped
    from object_detection_destr_tpu_torch.train.steps import CapturedEvalStep

    captured = CapturedEvalStep(eager_step)
    outputs = []
    with _cudnn_deterministic(torch, True):
        for i, batch in enumerate(batches):
            want = _tensors(_cloned(eager_step(state, batch)))
            out = captured(state, batch)
            got = _tensors(out)
            if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{label}: batch {i}'s captured outputs and losses differ from the eager "
                                     f"step's under deterministic cuDNN")
            outputs.append(_cloned(out))
    default = CapturedEvalStep(eager_step)
    spread = _hold_to_spread(f"{label} default cuDNN", [_sample(torch, eager_step(state, batches[0]))
                                                        for _ in range(V_EAGER_RUNS)],
                             _sample(torch, default(state, batches[0])))
    eager_ms = time_cuda(torch, lambda: eager_step(state, batches[0]))
    captured_ms = time_cuda(torch, lambda: default(state, batches[0]))
    del default

    def both(note):
        cap, eag = sweep(captured), sweep(eager_step)
        if cap[:3] != eag[:3]:
            raise AssertionError(f"{label} {note}: the captured sweep {cap[:3]} differs from the eager {eag[:3]}")
        return cap

    with _cudnn_deterministic(torch, True):
        first = both("first sweep")
        save_checkpoint(work, "v_hold", state, {}, 0.0)
        ema_init, ema_update = _make_ema(0.5)
        ema = ema_init(state.model)
        train_two_steps(lambda: ema_update(ema, state.model))
        trained = both("after two train steps")
        if trained[0] == first[0]:
            raise AssertionError(f"{label}: two train steps left the sweep's losses {trained[0]} as they were")
        with _parameters_swapped(state.model, ema):
            swapped = both("with the EMA swapped in")
        restore_checkpoint(work, "v_hold", state)
        restored = sweep(captured)
        if restored[:3] != first[:3]:
            raise AssertionError(f"{label}: after the restore the captured sweep gives {restored[:3]}, the first "
                                 f"{first[:3]}")
    if len(captured._graphs) != 1:
        raise AssertionError(f"{label}: {len(captured._graphs)} graphs for one input shape")
    log(f"{label}: the captured eval step bit-equal to the eager on {len(batches)} batches (outputs and losses, "
        f"deterministic cuDNN); with cuDNN's default engines a captured batch {spread['losses']['captured']:.3g} / "
        f"{spread['outputs']['captured']:.3g} from the eager mean (losses / outputs; the eager pairs' largest "
        f"distance {spread['losses']['limit']:.3g} / {spread['outputs']['limit']:.3g}); eval step {eager_ms:.2f} ms "
        f"eager, {captured_ms:.2f} ms captured (CUDA events, copy-in and replay); the trainer's sweep captured = "
        f"eager: first {first[:3]}, after two train steps {trained[:3]}, EMA swapped in {swapped[:3]}, the first "
        f"weights restored {restored[:3]}; one graph, {captured.replays} replays")
    return captured, outputs, {"eager_ms": eager_ms, "captured_ms": captured_ms, "first": first[:3],
                               "trained": trained[:3], "swapped": swapped[:3], "replays": captured.replays,
                               "spread": {k: {"captured": v["captured"], "limit": v["limit"]}
                                          for k, v in spread.items()}}


def phase_val_device(torch, kernels, seed, card):
    """Phase 22: validation as the JAX package runs it. (a) The greedy-match
    kernel against its plain version, hits bit-equal, at the path's three
    launches (config 2's COCO records B=8 C=80 K=100 T=300 J=10; config 1's
    11-point metric B=12 C=80 R=300 T=300; DESTR's one-class metric B=16
    R=300) with planted ties, rows at exactly 0.5, NaN rows and problems
    without a target; times beside the plain version's and the bound. (b)
    Both metrics on the card against the plain version on CPU copies, states
    and APs exactly equal: on seeded detections at config 2's and config 1's
    shapes, and on the captured eval steps' outputs below. (c) The captured
    eval step against the eager one for DESTR at config 2's shapes (800 px,
    81 classes, B=8, bf16) and SSD at config 1's (300 px, 80 classes, B=12,
    bf16), on a COCO-layout tree (v_hold); a traced replayed DESTR batch
    with both metric updates: 18 #1, 1 #9 and 2 greedy-match launches."""
    import itertools
    import re

    from object_detection_destr_tpu_torch.data.transforms import ssd_eval_transform, ssd_train_transform
    from object_detection_destr_tpu_torch.geometry.boxes import cxcyhw_to_xyxy
    from object_detection_destr_tpu_torch.losses.metrics import CocoAveragePrecision, MeanAveragePrecision
    from object_detection_destr_tpu_torch.models.ssd import build_ssd
    from object_detection_destr_tpu_torch.train.driver import (
        _destr_run,
        _eval_batch,
        _make_loaders,
        _mesh_of,
        _ssd_val_sweep,
        _to_device,
        _val_sweep,
    )
    from object_detection_destr_tpu_torch.train.state import create_ssd_state
    from object_detection_destr_tpu_torch.train.steps import make_destr_eval_step, make_ssd_eval_step, \
        make_ssd_train_step

    t0 = time.perf_counter()
    seconds, last = {}, [t0]

    def lap(name):
        """The seconds since the previous lap, as ``name``'s."""
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    cells = [greedy_cell(torch, seed + i, *cell) for i, cell in enumerate(GREEDY_CELLS)]
    lap("kernel")
    as_torch = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    synth = {
        C2_LABEL: metric_states_equal(
            torch, f"{C2_LABEL} seeded detections", [tuple(as_torch(d) for d in synth_detections(
                seed + i, C2_B, 300, C2_NUM_CLS, 300, C2_NUM_CLS - 1)) for i in range(2)],
            MeanAveragePrecision(1, num_pred=300), CocoAveragePrecision(C2_NUM_CLS - 1)),
        C1_LABEL: metric_states_equal(
            torch, f"{C1_LABEL} seeded detections", [tuple(as_torch(d) for d in synth_detections(
                seed + 10 + i, C1_B, 8732, C1_NUM_CLS + 1, 300, C1_NUM_CLS)) for i in range(2)],
            MeanAveragePrecision(C1_NUM_CLS)),
    }
    for name, s in synth.items():
        log(f"{V_LABEL} metrics on seeded detections at {name}'s shapes: the card's states and APs equal the plain "
            f"version's on CPU copies (tp {s['tp']:.0f}, fp {s['fp']:.0f}, mAP {s['map']:.6f}, COCO AP "
            f"{s['coco_map']}; COCO's scores within {s['coco_score_gap']:.2e} relative, hits exact); update "
            f"{s['update_ms']:.2f} ms a batch on the card (host clock to a synchronize)")
    lap("metrics")
    work = tempfile.mkdtemp(prefix="chip_smoke_v_",
                            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG, "_build"))
    try:
        root = os.path.join(work, "coco")
        write_coco_tree(root, seed, n_train=V_TRAIN_IMAGES, n_valid=V_VALID_IMAGES)
        device = torch.device("cuda")
        # DESTR at config 2's shapes, the trainer's own run (random weights from the seed)
        config = recipe_config(c2_args(root) + ["--seed", str(seed), "--num_train_samples", str(V_TRAIN_IMAGES),
                                                "--num_valid_samples", str(V_VALID_IMAGES)])
        mesh, step_mesh, device = _mesh_of(config, device, None)
        run, train_loader, _ = _destr_run(config, mesh, step_mesh, device)
        state = run.state
        valid = lambda: _make_loaders(config, C2_CANVAS, "destr")[1]
        batches = [_eval_batch(raw, device, C2_CANVAS, C2_IMAGE) for raw in valid()]
        metric, coco = MeanAveragePrecision(1, num_pred=300), CocoAveragePrecision(C2_NUM_CLS - 1)
        gen = torch.Generator(device=device)

        def destr_steps(after):
            for raw in itertools.islice(train_loader, 2):
                run.eager_step(raw, device, gen, seed)
                after()

        captured, outs, destr = v_hold(
            torch, f"{V_LABEL} {C2_LABEL}", state, make_destr_eval_step(config.train), batches,
            lambda step: _val_sweep(state, valid(), step, metric, coco, device, C2_CANVAS, C2_IMAGE),
            destr_steps, work)
        targets = [{k: b[k] for k in ("boxes", "labels", "valid")} for b in batches]
        pairs = [({k: o[0][k] for k in ("pred_class", "pred_boxes")}, tg) for o, tg in zip(outs, targets)]
        destr["metrics"] = metric_states_equal(torch, f"{C2_LABEL} eval outputs", pairs, metric, coco)

        def one_batch(scope):
            with scope(0):
                outputs, _ = captured(state, batches[0])
                metric.update(metric.init_state(device), outputs, targets[0])
                coco.update(outputs, targets[0])

        window = traced(torch, "v_destr_eval", 1, one_batch)
        greedy_traced = sum(n for name, n in window["launches"].items() if re.search(r"greedy_match_kernel", name))
        if window["per_step"] != [18, 0, 0, 0, 1, 0] or greedy_traced != 2:
            raise AssertionError(f"{V_LABEL}: a traced replayed DESTR eval batch launched #1/#2/#3/#4/#9/#8 "
                                 f"{window['per_step']} and the greedy match {greedy_traced} times")
        destr["traced"] = {"per_step": window["per_step"], "greedy": greedy_traced,
                           "busy_ms": window["step_busy_ms"], "period_ms": window["step_period_ms"]}
        log(f"{V_LABEL} {C2_LABEL}: a traced replayed eval batch with both metric updates: #1/#2/#3/#4/#9/#8 "
            f"{window['per_step']}, greedy match {greedy_traced}; device busy {window['step_busy_ms']:.2f} ms of "
            f"{window['step_period_ms']:.2f}")
        del run, state, captured, batches, outs, train_loader
        torch.cuda.empty_cache()
        lap("destr")

        # SSD at config 1's shapes
        base = c1_args(root, seed, work) + ["--num_train_samples", str(V_TRAIN_IMAGES), "--num_valid_samples",
                                            str(V_VALID_IMAGES)]
        config = c1_config(base)
        cfg, ssd_cfg = config.train, config.ssd
        train_loader, valid_loader = _make_loaders(config, C1_CANVAS, "ssd")
        torch.manual_seed(seed)
        state = create_ssd_state(build_ssd(ssd_cfg, device), cfg, steps_per_epoch=len(train_loader))
        valid = lambda: _make_loaders(config, C1_CANVAS, "ssd")[1]

        def ssd_batch(raw):
            b = _to_device(raw, device)
            return ssd_eval_transform(b["images"], b["boxes"], b["labels"], b["valid"], out_size=ssd_cfg.image_size)

        batches = [ssd_batch(raw) for raw in valid()]
        train_step = make_ssd_train_step(cfg, ssd_cfg)
        metric = MeanAveragePrecision(C1_NUM_CLS)

        def ssd_steps(after):
            for raw in itertools.islice(train_loader, 2):
                b = _to_device(raw, device)
                gen.manual_seed(seed + state.step)
                train_step(state, ssd_train_transform(b["images"], b["boxes"], b["labels"], b["valid"], gen,
                                                      out_size=ssd_cfg.image_size))
                after()

        captured, outs, ssd = v_hold(
            torch, f"{V_LABEL} {C1_LABEL}", state, make_ssd_eval_step(cfg, ssd_cfg), batches,
            lambda step: _ssd_val_sweep(state, valid(), step, metric, device, ssd_cfg.image_size), ssd_steps, work)
        pairs = [(o[2], {"boxes": cxcyhw_to_xyxy(b["boxes"]), "labels": b["labels"], "valid": b["valid"]})
                 for o, b in zip(outs, batches)]
        ssd["metrics"] = metric_states_equal(torch, f"{C1_LABEL} eval detections", pairs, metric)
        del state, captured, batches, outs
        torch.cuda.empty_cache()
        lap("ssd")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"greedy_cells": cells, "synthetic": synth, "destr": destr, "ssd": ssd,
           "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    greedy_ms = ", ".join(f"{c['label']} {c['ms']:.4f}" for c in cells)
    log(f"{V_LABEL} ({card}): greedy match device ms {greedy_ms}; "
        f"DESTR eval step at {C2_LABEL} {destr['eager_ms']:.2f} ms eager, {destr['captured_ms']:.2f} captured; SSD "
        f"at {C1_LABEL} {ssd['eager_ms']:.2f} eager, {ssd['captured_ms']:.2f} captured; metric update at "
        f"{C2_LABEL} {synth[C2_LABEL]['update_ms']:.2f} ms, at {C1_LABEL} {synth[C1_LABEL]['update_ms']:.2f} ms a batch; "
        f"phase {out['seconds']:.1f} s, by part {json.dumps(_rounded(seconds))}")
    return out


# phase 23, the span stamp (csrc/span_stamp.cu): the rows of a recorder's
# buffer (runtime/spans.py::SpanRecorder, 64 columns) stamped a row a replay,
# a step's 28 boundaries in an order that is not the columns' own, the slots
# outside the rows, and the spin kernels (cycles) a stamp pair is held to
# CUDA events around
SPAN_ROWS = 32
SPAN_BOUNDARIES = 28
SPAN_OUTSIDE = (-1, SPAN_ROWS, SPAN_ROWS + 7)
SPAN_SPINS = (200_000, 1_000_000, 10_000_000)
SPAN_HEAD = 4_000_000  # cycles of spin ahead of each pair (about 2 ms), so no host launch gap falls inside it
SPAN_SOURCE = f"{PKG}/csrc/span_stamp.cu"


def span_rows_rise(label, stamps, plan):
    """Each row's stamps rise in the plan's (stream) order, and each row
    begins after the row before ends."""
    rows = stamps[:, plan]
    if not bool((rows.diff(dim=1) >= 0).all()) or not bool((rows[1:, 0] >= rows[:-1, -1]).all()):
        raise AssertionError(f"span stamp {label}: stamps do not rise along the stream")


def phase_span_stamp(torch) -> dict:
    """The span stamp on the card against its plain version on the host,
    with the same slots and columns at the recorder's shape: eagerly a row
    at a time, then one replay's stamps captured and replayed a row a
    replay; both also with the slots outside the rows, which write
    nothing. The same cells are written, and no others; the stamps rise
    along the stream. A stamp pair around a spin kernel agrees with CUDA
    events recorded just inside it. Launches counted from 0 at the phase's
    start (every earlier phase ran without a recorder: none)."""
    from object_detection_destr_tpu_torch.ops.cuda.span_stamp import span_stamp_kernel, span_stamp_reference
    from object_detection_destr_tpu_torch.runtime.spans import SpanRecorder

    columns = SpanRecorder.COLUMNS
    plan = [(7 * k + 3) % columns for k in range(SPAN_BOUNDARIES)]
    path_launches = span_stamp_kernel.launches
    if path_launches:
        raise AssertionError(f"span stamp: {path_launches} launches on the paths of the earlier phases, none "
                             f"expected without a recorder")
    span_stamp_kernel.launches = 0  # the phase's launches start here
    host = torch.zeros((SPAN_ROWS, columns), dtype=torch.int64)
    host_slot = torch.zeros((1,), dtype=torch.int64)
    for row in [*range(SPAN_ROWS), *SPAN_OUTSIDE]:
        host_slot.fill_(row)
        for column in plan:
            span_stamp_reference(host, host_slot, column)
    written = host != 0
    if int(written.sum()) != SPAN_ROWS * SPAN_BOUNDARIES:
        raise AssertionError("span stamp: the plain version wrote other cells than the plan's")

    eager = torch.zeros((SPAN_ROWS, columns), dtype=torch.int64, device="cuda")
    slot = torch.zeros((1,), dtype=torch.int64, device="cuda")
    for row in [*range(SPAN_ROWS), *SPAN_OUTSIDE]:
        slot.fill_(row)
        for column in plan:
            span_stamp_kernel(eager, slot, column)
    torch.cuda.synchronize()
    eager_launches = span_stamp_kernel.launches
    captured = torch.zeros_like(eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for column in plan:
            span_stamp_kernel(captured, slot, column)
    capture_launches = span_stamp_kernel.launches - eager_launches
    for row in [*range(SPAN_ROWS), *SPAN_OUTSIDE]:
        slot.fill_(row)
        graph.replay()
    torch.cuda.synchronize()
    replay_launches = span_stamp_kernel.launches - eager_launches - capture_launches
    for label, stamps in (("eager", eager.cpu()), ("captured", captured.cpu())):
        if not torch.equal(stamps != 0, written):
            raise AssertionError(f"span stamp {label}: {int(((stamps != 0) != written).sum())} cells differ from "
                                 f"the plain version's written cells")
        span_rows_rise(label, stamps, plan)
    span_rows_rise("plain", host, plan)
    expected = (SPAN_ROWS + len(SPAN_OUTSIDE)) * SPAN_BOUNDARIES
    if (eager_launches, capture_launches, replay_launches) != (expected, SPAN_BOUNDARIES, 0):
        raise AssertionError(f"span stamp launches: eager {eager_launches}, capture {capture_launches}, replays "
                             f"{replay_launches}; expected {expected}, {SPAN_BOUNDARIES}, 0")
    del graph

    # a stamp pair around a spin kernel against CUDA events just inside it
    pair = torch.zeros((1, columns), dtype=torch.int64, device="cuda")
    pair_slot = torch.zeros((1,), dtype=torch.int64, device="cuda")
    spins = []
    for cycles in SPAN_SPINS:
        diffs = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPAN_HEAD)  # the host enqueues the rest while the device spins
            span_stamp_kernel(pair, pair_slot, 0)
            start.record()
            torch.cuda._sleep(cycles)
            end.record()
            span_stamp_kernel(pair, pair_slot, 1)
            torch.cuda.synchronize()
            stamp_ms = (int(pair[0, 1]) - int(pair[0, 0])) / 1e6
            diffs.append((stamp_ms, start.elapsed_time(end)))
        stamp_ms, event_ms = max(diffs, key=lambda d: abs(d[0] - d[1]))
        spins.append({"cycles": cycles, "event_ms": event_ms, "stamp_ms": stamp_ms, "gap_ms": stamp_ms - event_ms})
        if not -0.002 <= stamp_ms - event_ms <= 0.02 + 0.005 * event_ms:  # the timer ticks by up to 1 us
            raise AssertionError(f"span stamp: a stamp pair around a {cycles}-cycle spin reads {stamp_ms:.4f} ms, "
                                 f"CUDA events inside it {event_ms:.4f}")

    ms = device_ms(torch, lambda: span_stamp_kernel(pair, pair_slot, 2))
    t0 = time.perf_counter()
    for _ in range(200):
        span_stamp_reference(host, host_slot, 0)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 200
    bound_ms = 16 / HBM_RATE * 1e3  # the slot read and the stamp written
    out = {"path_launches": path_launches, "launches": eager_launches + capture_launches + replay_launches,
           "eager_launches": eager_launches, "capture_launches": capture_launches,
           "replay_launches": replay_launches, "spins": spins, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms}
    log(f"span stamp: {SPAN_ROWS} rows x {columns} columns, {SPAN_BOUNDARIES} stamps a row in stream order and "
        f"slots {list(SPAN_OUTSIDE)} outside the rows, eager and captured (a row a replay): the plain version's "
        f"cells and no others, rising along the stream; launches from 0: {eager_launches} eager, "
        f"{capture_launches} captured, {replay_launches} from {SPAN_ROWS + len(SPAN_OUTSIDE)} replays (the "
        f"earlier phases' paths {path_launches}); a stamp pair around a spin against CUDA events inside it: "
        + "; ".join(f"{s['cycles']} cycles {s['stamp_ms']:.4f} ms against {s['event_ms']:.4f}" for s in spins)
        + f"; ms={ms:.5f} (device, CUDA graph) plain_ms={plain_ms:.5f} (host) bound_ms={bound_ms:.2e} (bytes)")
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
        from object_detection_destr_tpu_torch.ops.cuda import greedy_match as gm
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script: {exc}", file=sys.stderr)
        return 1
    # the kernels in the order of their counts: #1, #2, #3, #4, #9, #8, #5, #6, #7
    kernels = [fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_dq, fa.flash_attention_dkv,
               auction.fused_auction, auction.auction_kernel, fa.flash_attention_unpacked_fwd,
               fa.flash_attention_unpacked_dq, fa.flash_attention_unpacked_dkv]

    t_start = time.perf_counter()
    phase_seconds, part_seconds, last = {}, {}, [t_start]
    val_ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")  # phase 6b's checkpoints, read again in phase 17

    def clock(name, part=None):
        """The seconds since the previous clock, added to ``name``'s (and
        to its ``part``'s)."""
        now = time.perf_counter()
        phase_seconds[name] = phase_seconds.get(name, 0.0) + now - last[0]
        if part is not None:
            part_seconds[f"{name} {part}"] = now - last[0]
        last[0] = now

    try:
        card = phase_device(torch)
        one_bf16 = one_bf16_backward(fa)
        phase_build([fa.FWD_LIBRARY, fa.BWD_LIBRARY, fa.TWO_PASS_LIBRARY, auction.LIBRARY, gm.LIBRARY,
                     one_bf16.library])
        clock("device and build")
        phase_plan(torch, fa)
        warm_clocks(torch)
        kernels_clock = functools.partial(clock, "kernels (3-5)")
        flash_rows = phase_flash(torch, args.seed)
        kernels_clock("3")
        beyond_rows, beyond_unpacked = phase_beyond_1024(torch, args.seed)
        kernels_clock("3d")
        shares = phase_dropout_share(torch, args.seed, flash_rows + beyond_rows)
        f32_shares = phase_dropout_share(torch, args.seed, flash_rows + beyond_rows, torch.float32,
                                         PATH_SITES + WIDE_SITES + [H1024_CROSS])
        kernels_clock("dropout shares")
        seed_checks = phase_seed_replay(torch, args.seed)
        split_rows = phase_split(torch, args.seed, one_bf16)
        unpacked_rows = phase_unpacked(torch, args.seed)
        api_counts = phase_unpacked_api(torch, kernels, args.seed)
        kernels_clock("seed, split, head-major")
        auction_rows, l2 = phase_auction(torch, args.seed)
        assign_rows, assign_counts = phase_assignment(torch, kernels, args.seed, l2)
        kernels_clock("auctions")
        runs = {}
        for label, extra, per_step_launches in (("hidden 256", [], (18, 18, 0, 0, 1, 0, 0, 0, 0)),
                                                ("hidden 512", WIDE_ARGS, (18, 12, 6, 6, 1, 0, 0, 0, 0)),
                                                ("hidden 1024", H1024_ARGS, H1024_PER_STEP),
                                                ("hidden 256 float32", F32_ARGS, (18, 18, 0, 0, 1, 0, 0, 0, 0)),
                                                ("hidden 512 float32", WIDE_ARGS + F32_ARGS,
                                                 (18, 12, 6, 6, 1, 0, 0, 0, 0))):
            state, counts, step_ms, _ = phase_train(torch, kernels, args.seed, extra, per_step_launches, label)
            parts = step_parts(torch, state, train_batch(torch, TRAIN_B, args.seed), recipe_train_config(extra))
            log(f"train {label}: where a step of make_destr_train_step goes, ms (CUDA events, median of 3) "
                + " ".join(f"{k}={v:.2f}" for k, v in parts.items())
                + f" rest={parts['step'] - sum(v for k, v in parts.items() if k != 'step'):.2f}")
            runs[label] = (counts, step_ms)
            del state
            torch.cuda.empty_cache()
            clock("train (6)", label)
        captured = {}
        for label, extra, per_step_launches, eager_runs, held in (
                ("hidden 256", [], (18, 18, 0, 0, 1, 0), EAGER_RUNS, HELD_STEPS),
                ("hidden 512", WIDE_ARGS, (18, 12, 6, 6, 1, 0), EAGER_RUNS, HELD_STEPS),
                ("hidden 1024", H1024_ARGS, H1024_PER_STEP[:6], 3, HELD_STEPS),
                ("hidden 256 float32", F32_ARGS, (18, 18, 0, 0, 1, 0), F32_EAGER_RUNS, HELD_STEPS),
                ("hidden 512 float32", WIDE_ARGS + F32_ARGS, (18, 12, 6, 6, 1, 0), F32_EAGER_RUNS,
                 HELD_STEPS)):
            captured[label] = phase_captured_train(torch, kernels, destr_capture_setup(torch, args.seed, extra),
                                                   per_step_launches, label, eager_runs=eager_runs, held_steps=held)
            torch.cuda.empty_cache()  # the runner's graph pool
            clock("captured train (6a)", label)
        val_counts, val_timing = phase_validation(torch, kernels, args.seed, val_ckpt)
        clock("validation (6b)")
        torch.cuda.empty_cache()
        scan = phase_train_scan(torch, args.seed)
        clock("epoch scan (6c)")
        torch.cuda.empty_cache()
        for destr in (None, {"hidden_dim": 512}, {"hidden_dim": 1024}):
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
        h1024 = phase_h1024_service(torch, kernels, args.seed, images)
        clock("hidden 1024 validation and serving (8a)")
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
        torch.cuda.empty_cache()  # the launchers' processes share the card with this one
        launchers = phase_launchers(card)
        clock("launchers (18)")
        torch.cuda.empty_cache()
        c4 = phase_config4(torch, kernels, args.seed, card)
        clock("config 4 (19)")
        torch.cuda.empty_cache()
        c2 = phase_config2(torch, kernels, args.seed, card)
        clock("config 2 (20)")
        torch.cuda.empty_cache()
        c1 = phase_config1(torch, kernels, args.seed, card)
        clock("config 1 (21)")
        torch.cuda.empty_cache()
        v = phase_val_device(torch, kernels, args.seed, card)
        clock("validation captured (22)")
        stamp = phase_span_stamp(torch)
        clock("span stamp (23)")
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
    flash_rows = flash_rows + beyond_rows
    h1024_rows = step_rows(H1024_SITES)
    h1024_fused, h1024_cross = h1024_rows[:2], h1024_rows[2:]
    # the same step cells on the device alone (CUDA-graph replay), dropout 0 and 0.3
    share_path = [r for r in shares if r["site"] in {s[0] for s in PATH_SITES}]
    share_wide = [r for r in shares if r["site"] in {s[0] for s in WIDE_SITES}]
    share_h1024 = [r for r in shares if r["site"] in {s[0] for s in H1024_SITES}]

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
    serve_h1024 = [r for r in beyond_rows for (n, *_, m) in H1024_SITES
                   if r["site"] == n and r["b"] == 1 and r["dtype"] == "float32" and r["masked"] == m]
    log("serving hidden 1024 float32 B=1, #1 device ms a launch (CUDA graph): "
        + "; ".join(f"{r['site']} {r['ms']:.4f} (SDPA {_ms_or_note(r, 'library')}, plain {r['plain_ms']:.4f}, "
                    f"bound {r['bound_ms']:.4f}, rel_err {r['rel_err']:.2e})" for r in serve_h1024)
        + f"; a request's 18 launches {BLOCKS * sum(r['ms'] for r in serve_h1024):.4f}")
    counts, step_ms = runs["hidden 256"]
    wide_counts, wide_step_ms = runs["hidden 512"]
    h1024_counts, h1024_step_ms = runs["hidden 1024"]

    def per_step(rows, key):
        """A step's (or request's) ms of a kernel: 6 blocks of each site's
        launch; None where a site has no such time (SDPA refused it)."""
        values = [r[key] for r in rows]
        return None if None in values else BLOCKS * sum(values)

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
        largest value at the cross sites (bfloat16; B=16, Sk 7056 at B=1), by
        site and rate."""
        return {f"{r['site']} rate {r['rate']}": {n: r["bwd_rel_err"][f"two_pass {n}"] for n in names}
                for r in flash_rows if r["site"] in (WIDE_CROSS[0], PATH_SITES[2][0], H1024_CROSS[0], H1024_LONG[0],
                                                     *(site[0] for site in BEYOND_SITES))
                and r["dtype"] == "bfloat16" and "two_pass dq" in r.get("bwd_rel_err", {})}
    log("bf16 #3 / #4 errors relative to the plain version's largest value: "
        + "; ".join(f"{k} " + " ".join(f"{n}={e:.2e}" for n, e in v.items())
                    for k, v in two_pass_rel_err(("dq", "dk", "dv")).items()))

    def unpacked_rows_of(rows, sites, dname="bfloat16"):
        names = [site[0] for site in sites]
        return [r for r in rows if r["site"] in names and r["b"] == TRAIN_B and r["dtype"] == dname
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
            "hidden_1024": {"launches": h1024_counts[0], "max_abs_err": max(r["max_abs_err"] for r in h1024_rows),
                            "ms": per_step(h1024_rows, "ms"), "plain_ms": per_step(h1024_rows, "plain_ms"),
                            "bound_ms": per_step(h1024_rows, "bound_ms"),
                            "library_ms": per_step(h1024_rows, "library_ms"), **device_rates(share_h1024, "fwd"),
                            "validation_launches": h1024["counts"][0], "evaluate_launches": h1024["eval_launches"],
                            "serving": {"launches": h1024["serve_launches"], "device_ms": per_step(serve_h1024, "ms"),
                                        "plain_ms": per_step(serve_h1024, "plain_ms"),
                                        "library_ms": per_step(serve_h1024, "library_ms"),
                                        "bound_ms": per_step(serve_h1024, "bound_ms"),
                                        "rel_err": max(r["rel_err"] for r in serve_h1024),
                                        "captured_ms": h1024["captured_ms"], "eager_ms": h1024["eager_ms"]},
                            "sites": {r["site"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                                      for r in h1024_rows},
                            "per": f"launches: train.main at hidden 1024 cut to {H1024_BLOCKS} + {H1024_BLOCKS} blocks "
                                   f"({H1024_PER_STEP[0]} a step); ms ...: a full-depth hidden-1024 train step's "
                                   "18 launches (d 128, 256 and the cross-attention's d "
                                   "2048, dv 1024), B=16, bfloat16, dropout 0.3, eager calls; validation_launches: "
                                   "2 steps and a validation batch; serving: a full-depth request's 18 float32 B=1 "
                                   "launches (CUDA graph), the latency (host clock, median of 8) of the service at "
                                   f"{H1024_BLOCKS} + {H1024_BLOCKS} blocks"},
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
            "hidden_1024": {"launches": h1024_counts[1], "max_abs_err": abs_err(h1024_fused, "fused"),
                            **timed(h1024_fused, "bwd"), "library_ms": per_step(h1024_fused, "bwd_library_ms"),
                            **device_rates(share_h1024, "bwd"),
                            "per": "ms ...: a full-depth step's 12 launches, encoder (d 128) and decoder (d 256) "
                                   f"self-attention; launches: train.main at {H1024_BLOCKS} + {H1024_BLOCKS} blocks"},
        },
        {
            "name": "flash_attention_dq", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_bwd_two_pass.cu",
            "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:778",
            "launches": wide_counts[2],
            "max_abs_err": abs_err(wide_cross, "two_pass", ("dq",)),
            **timed(wide_cross, "dq"), "library_ms": per_step(wide_cross, "bwd_library_ms"),
            **device_rates(share_wide, "dq"), "rel_err": two_pass_rel_err(("dq",)),
            "hidden_1024": {"launches": h1024_counts[2],
                            "max_abs_err": abs_err(h1024_cross, "two_pass", ("dq",)), **timed(h1024_cross, "dq"),
                            "library_ms": per_step(h1024_cross, "bwd_library_ms"),
                            **device_rates(share_h1024, "dq"),
                            "per": "ms ...: a full-depth step's 6 launches at the cross-attention (d 2048, dv 1024; "
                                   "the wide kernel, gradient columns in slices across grid.y), B=16, bfloat16, dropout "
                                   f"0.3, eager calls; launches: train.main at {H1024_BLOCKS} + {H1024_BLOCKS} blocks"},
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
            "hidden_1024": {"launches": h1024_counts[3],
                            "max_abs_err": abs_err(h1024_cross, "two_pass", ("dk", "dv")), **timed(h1024_cross, "dkv"),
                            "library_ms": per_step(h1024_cross, "bwd_library_ms"),
                            **device_rates(share_h1024, "dkv"),
                            "per": "ms ...: a full-depth step's 6 launches at the cross-attention (d 2048, dv 1024; "
                                   "the wide kernel, gradient columns in slices across grid.y), B=16, bfloat16, dropout "
                                   f"0.3, eager calls; launches: train.main at {H1024_BLOCKS} + {H1024_BLOCKS} blocks"},
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
            "validation": {"launches": val_counts[4],
                           "per": "4 train steps, and the captured eval step's warm-up and capture (its 4 replayed "
                                  "validation batches call no wrapper)"},
            "import": {"launches": imported["destr"]["launches"][4], "profile_per_step": imported["profile"]["per_step"][4]},
        },
    ]
    # the head-major kernels: one launch at each hidden-256 call-site shape
    # (B=16, bfloat16, dropout 0.3), hidden 512 beside; launches from the
    # public API's run (phase 3b)
    api_path, api_wide = unpacked_rows_of(unpacked_rows, PATH_SITES), unpacked_rows_of(unpacked_rows, WIDE_SITES)
    per = "one launch at each of the 3 hidden-256 call-site shapes, (B, h, S, d), B=16, bfloat16, dropout 0.3"
    h1024_unpacked = [r for r in beyond_unpacked if r["site"] == H1024_CROSS[0] and "ms" in r]
    entries.append({
        "name": "flash_attention_unpacked_fwd", "route": "cuda",
        "source": f"{PKG}/csrc/flash_attention_fwd.cu",
        "replaces": "object_detection_destr_tpu/ops/pallas/flash_attention.py:151",
        "launches": api_counts[6],
        "max_abs_err": max(r["max_abs_err"] for r in unpacked_rows),
        **sums(api_path, ""), "library_ms": sum(r["library_ms"] for r in api_path),
        "per": per + "; library_ms is SDPA forward",
        "hidden_512": {**sums(api_wide, ""), "library_ms": sum(r["library_ms"] for r in api_wide)},
        "hidden_1024_cross": {**sums(h1024_unpacked, ""), "library_ms": h1024_unpacked[0]["library_ms"],
                              "max_abs_err": max(r["max_abs_err"] for r in beyond_unpacked),
                              "per": "one launch at hidden 1024's cross-attention (d 2048, dv 1024), (B, h, S, d), "
                                     "B=16, bfloat16, dropout 0.3, eager; max_abs_err over every site past 1024"},
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
            "hidden_1024_cross": {**sums(h1024_unpacked, kind + "_"), "library_ms": h1024_unpacked[0]["bwd_library_ms"],
                                  "max_abs_err": max(r["bwd_abs_err"][n] for r in beyond_unpacked for n in names)},
        })
    # float32: train-640-f32 (hidden 256, every backward on the 3xTF32 #2),
    # train-640-wide-f32 (hidden 512: #2 at the self-attention, the 3xTF32
    # #3 / #4 at the cross-attention) and the kernel cells of hidden 256, 512
    # and 1024's cross-attention (the wide 3xTF32 #3 / #4)
    f32_counts, f32_step_ms = runs["hidden 256 float32"]
    f32_cap = captured["hidden 256 float32"]
    f32w_counts, f32w_step_ms = runs["hidden 512 float32"]
    f32w_cap = captured["hidden 512 float32"]
    f32_rows = [r for r in flash_rows if r["b"] == TRAIN_B and r["dtype"] == "float32" and r["rate"] == RATE
                and r.get("bwd_plan") in ("fused", "two_pass")]
    f32_path = [r for r in f32_rows if r["site"] in {s[0] for s in PATH_SITES}]
    f32_wide_fused = [r for r in f32_rows if r["site"] in {s[0] for s in WIDE_SITES} and r["bwd_plan"] == "fused"]
    f32_wide_cross = [r for r in f32_rows if r["site"] == WIDE_CROSS[0]]
    f32_h1024_cross = [r for r in f32_rows if r["site"] == H1024_CROSS[0]]
    f32_share_path = [r for r in f32_shares if r["site"] in {s[0] for s in PATH_SITES}]
    f32_share_wide = [r for r in f32_shares if r["site"] in {s[0] for s in WIDE_SITES}]
    f32_share_h1024 = [r for r in f32_shares if r["site"] == H1024_CROSS[0]]
    f32_per = "B=16, float32 (3xTF32 on the tensor cores), dropout 0.3, eager calls; device_ms_rate_* the same " \
              "launches from CUDA-graph replay; " + sdpa
    entries[0]["float32"] = {"launches": f32_counts[0], "captured_device_ms": f32_cap["captured_kernel_ms"][0],
                             "per": "train-640-f32: 4 steps (18 a step); captured_device_ms a replayed step's 18 "
                                    "launches from a trace of 3",
                             "hidden_512": {"launches": f32w_counts[0],
                                            "captured_device_ms": f32w_cap["captured_kernel_ms"][0],
                                            "per": "train-640-wide-f32, the same"}}
    entries[1]["float32"] = {
        "launches": f32_counts[1], "max_abs_err": abs_err(f32_path, "fused"), **timed(f32_path, "bwd"),
        "library_ms": per_step(f32_path, "bwd_library_ms"), **device_rates(f32_share_path, "bwd"),
        "captured_device_ms": f32_cap["captured_kernel_ms"][1], "eager_device_ms": f32_cap["eager_kernel_ms"][1],
        "per": "train-640-f32 step: 18 launches (3 call sites x 6 blocks), " + f32_per + "; captured_device_ms / "
               "eager_device_ms a step's 18 launches from traces of 3 steps",
        "hidden_512": {"launches": f32w_counts[1], "max_abs_err": abs_err(f32_wide_fused, "fused"),
                       **timed(f32_wide_fused, "bwd"), "library_ms": per_step(f32_wide_fused, "bwd_library_ms"),
                       **device_rates(f32_share_wide, "bwd"), "captured_device_ms": f32w_cap["captured_kernel_ms"][1],
                       "eager_device_ms": f32w_cap["eager_kernel_ms"][1],
                       "per": "train-640-wide-f32: 12 launches a step (encoder and decoder self-attention)"}}
    for entry, index, kind, names in ((entries[2], 2, "dq", ("dq",)), (entries[3], 3, "dkv", ("dk", "dv"))):
        entry["float32"] = {
            "launches": f32w_counts[index], "max_abs_err": abs_err(f32_wide_cross + f32_h1024_cross, "two_pass", names),
            **timed(f32_wide_cross, kind), "library_ms": per_step(f32_wide_cross, "bwd_library_ms"),
            **device_rates(f32_share_wide, kind), "captured_device_ms": f32w_cap["captured_kernel_ms"][index],
            "eager_device_ms": f32w_cap["eager_kernel_ms"][index],
            "rel_err": {f"{r['site']} B={r['b']} rate {r['rate']}" + (" (entry 0 fully masked)"
                                                                        if r["fully_masked_entry"] else ""):
                        {n: r["bwd_rel_err"][f"two_pass {n}"] for n in names}
                        for r in flash_rows if r["dtype"] == "float32" and r.get("bwd_plan") == "two_pass"},
            "per": "train-640-wide-f32 step: 6 launches at the merged cross-attention (d 1024, dv 512; "
                   "flash_two_pass_f32_kernel), " + f32_per + "; captured_device_ms / eager_device_ms a step's 6 "
                   "launches from traces of 3 steps; rel_err: every float32 cell of the two-pass kernels",
            "hidden_1024": {**timed(f32_h1024_cross, kind), "library_ms": per_step(f32_h1024_cross, "bwd_library_ms"),
                            **device_rates(f32_share_h1024, kind),
                            "per": "6 launches at hidden 1024's cross-attention (d 2048, dv 1024; "
                                   "flash_two_pass_f32_wide_kernel), " + f32_per}}
    f32_unpacked = unpacked_rows_of(unpacked_rows, PATH_SITES, "float32")
    f32_unpacked_0 = [r for r in unpacked_rows if r["site"] in {s[0] for s in PATH_SITES} and r["b"] == TRAIN_B
                      and r["dtype"] == "float32" and r["rate"] == 0.0]
    for entry, kind in ((entries[-2], "dq"), (entries[-1], "dkv")):
        entry["float32"] = {**sums(f32_unpacked, kind + "_"),
                            "device_ms_rate_0.0": sum(r[kind + "_device_ms"] for r in f32_unpacked_0),
                            f"device_ms_rate_{RATE}": sum(r[kind + "_device_ms"] for r in f32_unpacked),
                            "library_ms": sum(r["bwd_library_ms"] for r in f32_unpacked),
                            "per": "one launch at each of the 3 hidden-256 call-site shapes, (B, h, S, d), B=16, "
                                   "float32 (3xTF32), dropout 0.3, eager; device_ms_rate_* the same launches from "
                                   "CUDA-graph replay; " + sdpa}
        log(f"float32 #{6 if kind == 'dq' else 7} (head-major) ms a launch at the hidden-256 sites: "
            + "; ".join(f"{r['site']} device {r0[kind + '_device_ms']:.4f} / {r[kind + '_device_ms']:.4f} at dropout "
                        f"0 / {RATE} (eager {r[kind + '_ms']:.4f}, plain {r[kind + '_plain_ms']:.4f}, bound "
                        f"{r[kind + '_bound_ms']:.4f}, SDPA forward + backward {_ms_or_note(r, 'bwd_library')}; the "
                        f"CUDA-core kernel's recorded eager {CUDA_CORE_F32_RECORDED_UNPACKED_MS[kind][r['site']]:.4f}, "
                        f"not this run)"
                        for r0, r in zip(f32_unpacked_0, f32_unpacked)))
    for label, cells, shares_of, counts_of, cap in (
            ("train-640-wide-f32 (hidden 512)", f32_wide_cross,
             [r for r in f32_share_wide if r["site"] == WIDE_CROSS[0]], f32w_counts, f32w_cap),
            ("hidden 1024's cross-attention (the wide class)", f32_h1024_cross, f32_share_h1024, None, None)):
        site = cells[0]["site"]
        log(f"float32 #3 / #4 (3xTF32), {label}, 6 launches a step: device ms at dropout 0 / {RATE} (CUDA graph) "
            + "; ".join(f"#{3 if kind == 'dq' else 4} {per_step(shares_of, f'{kind}_ms_0.0'):.4f} / "
                        f"{per_step(shares_of, f'{kind}_ms_{RATE}'):.4f} (eager {per_step(cells, kind + '_ms'):.4f}, "
                        f"bound {per_step(cells, kind + '_bound_ms'):.4f}; the CUDA-core kernel's recorded "
                        f"{BLOCKS * CUDA_CORE_F32_RECORDED_DEVICE_MS[kind][site]:.4f} at {RATE}, not this run)"
                        for kind in ("dq", "dkv"))
            + f"; SDPA forward + backward {per_step(cells, 'bwd_library_ms')}"
            + ("" if cap is None else
               f"; a replayed step's #3 / #4 {cap['captured_kernel_ms'][2]:.4f} / {cap['captured_kernel_ms'][3]:.4f} "
               f"(trace); the step captured {cap['captured_ms']:.2f} ms (eager {cap['eager_ms']:.2f}, idle "
               f"{cap['captured_idle_share']:.4f}), launches {[c // TRAIN_STEPS for c in counts_of]} a step"))
    log(f"float32: #2 a train-640-f32 step (18 launches) device ms {entries[1]['float32']['device_ms_rate_0.0']:.4f} / "
        f"{entries[1]['float32'][f'device_ms_rate_{RATE}']:.4f} at dropout 0 / {RATE} (CUDA graph; the CUDA-core "
        f"kernel's recorded {BLOCKS * sum(CUDA_CORE_F32_RECORDED_DEVICE_MS['bwd'][s[0]] for s in PATH_SITES):.4f} at "
        f"{RATE}, not this run), {f32_cap['captured_kernel_ms'][1]:.4f} a replayed step (trace), bound "
        f"{entries[1]['float32']['bound_ms']:.4f}, SDPA forward + backward {entries[1]['float32']['library_ms']}; "
        f"the step captured {f32_cap['captured_ms']:.2f} ms (eager {f32_cap['eager_ms']:.2f}, idle "
        f"{f32_cap['captured_idle_share']:.4f}), launches {[c // TRAIN_STEPS for c in f32_counts]} a step")
    log(f"train step median ms: hidden 256 {step_ms:.2f} ({TRAIN_B / step_ms * 1e3:.1f} images/s), hidden 512 "
        f"{wide_step_ms:.2f} ({TRAIN_B / wide_step_ms * 1e3:.1f} images/s), hidden 1024 {h1024_step_ms:.2f} "
        f"({TRAIN_B / h1024_step_ms * 1e3:.1f} images/s); hidden 1024 request median ms "
        f"{h1024['captured_ms']:.2f} (eager {h1024['eager_ms']:.2f}), evaluated map {h1024['map']:.6f}; kernels per step ms "
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
        f"launchers: prod DESTR {launchers['train_prod_synth_torch.sh']['seconds']:.1f} s, prod SSD "
        f"{launchers['train_prod_ssd_torch.sh']['seconds']:.1f} s, evaluate {launchers['evaluate']['seconds']:.1f} s, "
        f"phase {launchers['seconds']:.1f} s; {C4_LABEL}: step ms eager {c4['step_ms']:.2f}, captured "
        f"{c4['captured']['captured_ms']:.2f}, request ms {c4['serving']['captured_ms']:.2f}, phase "
        f"{c4['seconds']:.1f} s; {C2_LABEL}: step ms eager {c2['step_ms']:.2f}, captured "
        f"{c2['captured']['captured_ms']:.2f}, request ms {c2['serving']['captured_ms']:.2f}, batched bf16 forward "
        f"ms {c2['forward']['captured_ms']:.2f} ({c2['forward']['images_per_sec']:.1f} images/s), validation "
        f"{c2['evaluate']['sweep_images_per_sec']:.1f} images/s ({c2['evaluate']['warm_sweep_images_per_sec']:.1f} on "
        f"the graph), phase {c2['seconds']:.1f} s; {C1_LABEL}: step ms "
        f"eager {c1['step_ms']:.2f}, captured {c1['captured']['captured_ms']:.2f}, request ms "
        f"{c1['serving']['captured_ms']:.2f}, validation {c1['evaluate']['sweep_images_per_sec']:.1f} images/s "
        f"({c1['evaluate']['warm_sweep_images_per_sec']:.1f} on the graph), phase {c1['seconds']:.1f} s; "
        f"{V_LABEL}: DESTR eval step {v['destr']['eager_ms']:.2f} ms eager, {v['destr']['captured_ms']:.2f} captured, "
        f"SSD {v['ssd']['eager_ms']:.2f} / {v['ssd']['captured_ms']:.2f}, phase {v['seconds']:.1f} s; total "
        f"{time.perf_counter() - t_start:.0f} s ({card}); seconds by phase "
        f"{json.dumps(_rounded(phase_seconds))}; by part {json.dumps(_rounded(part_seconds))}")
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
                           "per": "phase 17: val_noise's sweeps (their captured eval step's warm-up and capture, "
                                  "18 each), a post-mortem replayed step; "
                                  "probe_flash's device ms of one launch (CUDA graph, best of 3) at Sk = Sq, no mask"}
    entries[1]["tools"] = {"postmortem_per_step": pm["per_step"][1],
                           "probe_flash": {k: probe[k] for k in ("sq", "b", "heads", "rate", "backward_plan",
                                                                 "fwd_bwd_ms", "fwd_bwd_bound_ms", "sdpa_fwd_bwd_ms")},
                           "per": "phase 17: a post-mortem replayed step; probe_flash's #1 + #2 device ms"}
    entries[5]["tools"] = {"val_noise_launches": tools["val_noise"]["launches"][4],
                           "postmortem_per_step": pm["per_step"][4]}
    prod = launchers["train_prod_synth_torch.sh"]["launches"]
    for entry, index in ((entries[0], 0), (entries[1], 1), (entries[5], 4)):
        entry["launchers"] = {"train_prod_synth_torch": prod[index], "evaluate": launchers["evaluate"]["launches"][index],
                              "per": "phase 18, counted in the subprocesses: scripts/train_prod_synth_torch.sh, one "
                                     "epoch of 2 steps with --epoch_scan (eager warm-up and capture) and its live and "
                                     "EMA sweeps' captured eval step (warm-up and capture); infer.evaluate on its "
                                     "checkpoint (its captured forward's warm-up and capture)"}
    c4_cap, c4_sites = c4["captured"], c4["profile"]["sites"]
    for entry, index in ((entries[0], 0), (entries[1], 1), (entries[5], 4)):
        entry["config_4"] = {
            "launches": c4["counts"][index], "evaluate_launches": c4["eval_counts"][index],
            "per_step": C4_PER_STEP[index], "captured_device_ms": c4_cap["captured_kernel_ms"][index],
            "eager_device_ms": c4_cap["eager_kernel_ms"][index],
            "per": f"{C4_LABEL} (ResNet-101, dilated C5, {C4_IMAGE} px, B=1, bfloat16, 7056 encoder tokens): "
                   f"launches of train.main's 4 steps and its captured eval step's warm-up and capture; "
                   f"*_device_ms a step from traces of 3 steps"}
    for entry, kernel in ((entries[0], "#1"), (entries[1], "#2")):
        entry["config_4"]["replayed_site_ms"] = c4_sites[kernel]
    c4_flash = c4["flash_cells"]
    entries[0]["config_4"].update(
        max_abs_err=max(r["max_abs_err"] for r in c4_flash), ms=per_step(c4_flash, "ms"),
        plain_ms=per_step(c4_flash, "plain_ms"), bound_ms=per_step(c4_flash, "bound_ms"),
        bound_by=bound_by(c4_flash, "bound_by"), library_ms=per_step(c4_flash, "library_ms"))
    entries[1]["config_4"].update(max_abs_err=abs_err(c4_flash, "fused"), **timed(c4_flash, "bwd"),
                                  library_ms=per_step(c4_flash, "bwd_library_ms"))
    entries[5]["config_4"].update({k: c4["auction"][k] for k in ("ms", "kernel_device_ms", "plain_ms", "bound_ms",
                                                                 "bound_by", "rounds", "bids")})
    for entry in (entries[0], entries[1]):
        entry["config_4"]["per"] += ("; ms, plain_ms, bound_ms, library_ms: a step's 18 launches at the three sites "
                                     "(B=1, bfloat16, dropout 0.3, eager calls; SDPA for library_ms)")
    entries[5]["config_4"]["per"] += f"; ms ... bids: one launch on the step's 2 problems of N={C4_TOKENS}"
    entries[0]["config_4"]["serving"] = {"launches_per_request": 3 * BLOCKS,
                                         "device_ms": c4["serving"]["captured_kernel_ms"][0],
                                         "per": "a float32 request at 1333 px (trace of 4 replays)"}
    c2_cap, c2_step, c2_forward = c2["captured"], c2["step_cells"], c2["forward_cells"]
    for entry, index in ((entries[0], 0), (entries[1], 1), (entries[5], 4)):
        entry["config_2"] = {
            "launches": c2["counts"][index], "per_step": C2_PER_STEP[index],
            "captured_device_ms": c2_cap["captured_kernel_ms"][index],
            "eager_device_ms": c2_cap["eager_kernel_ms"][index],
            "per": f"{C2_LABEL} (DESTR-R50, --num_cls {C2_NUM_CLS}, {C2_IMAGE} px, B={C2_B}, bfloat16, a COCO-layout "
                   f"tree, {C2_TOKENS} encoder tokens): launches of train.main's 4 steps and its captured eval "
                   f"step's warm-up and capture; *_device_ms a step from traces of 3 steps"}
    entries[0]["config_2"].update(
        max_abs_err=max(r["max_abs_err"] for r in c2_step), ms=per_step(c2_step, "ms"),
        plain_ms=per_step(c2_step, "plain_ms"), bound_ms=per_step(c2_step, "bound_ms"),
        bound_by=bound_by(c2_step, "bound_by"), library_ms=per_step(c2_step, "library_ms"),
        evaluate_launches=c2["evaluate"]["counts"][0], cli_launches=c2["serving"]["cli_counts"][0],
        forward={k: c2["forward"][k] for k in ("launches", "eager_ms", "captured_ms", "images_per_sec",
                                                "captured_step_busy_ms", "captured_idle_share", "peak_gb")},
        sites={f"{r['site']} {r['dtype']} B={r['b']}": {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                                           "bound_by", "max_abs_err", "rel_err")}
               for r in c2_forward})
    entries[1]["config_2"].update(max_abs_err=abs_err(c2_step, "fused"), **timed(c2_step, "bwd"),
                                  library_ms=per_step(c2_step, "bwd_library_ms"))
    entries[5]["config_2"].update({k: c2["auction"][k] for k in ("ms", "kernel_device_ms", "plain_ms", "bound_ms",
                                                                 "bound_by", "rounds", "bids", "classes",
                                                                 "max_abs_err")})
    for entry in (entries[0], entries[1]):
        entry["config_2"]["per"] += ("; ms, plain_ms, bound_ms, library_ms: a step's 18 launches at the three sites "
                                     "(B=8, bfloat16, dropout 0.3, eager calls; SDPA for library_ms)")
    entries[0]["config_2"]["per"] += ("; evaluate_launches: infer.evaluate's captured forward (warm-up and "
                                      "capture); cli_launches: one infer.cli "
                                      "invocation on 8 images; forward: bench.py's infer mode (B=8, bfloat16, "
                                      "replayed), 18 launches a forward; sites: one launch each, device ms (CUDA "
                                      "graph), dropout 0")
    entries[5]["config_2"]["per"] += (f"; ms ... classes: one launch at C={C2_NUM_CLS} on a step's "
                                      f"{2 * C2_B} problems of N={C2_TOKENS}, rows equal to the plain version's")
    for entry, index in ((entries[0], 0), (entries[5], 4)):
        entry["validation_captured"] = {
            "traced_replayed_batch": v["destr"]["traced"]["per_step"][index],
            "per": f"phase 22: launches in a traced replayed {C2_LABEL} eval batch (CUDA graph)"}
    cell = v["greedy_cells"][0]
    entries.append({
        "name": "greedy_match", "route": "cuda", "source": GREEDY_SOURCE, "replaces": GREEDY_REPLACES,
        "launches": val_timing["greedy_launches"], "max_abs_err": max(c["max_abs_err"] for c in v["greedy_cells"]),
        "ms": cell["ms"], "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
        "library_ms": None,
        "per": f"one launch at {cell['label']} (P={cell['problems']} problems, R={cell['ranks']}, T={cell['targets']}, "
               f"J={cell['thresholds']}, COCO's rule), device ms from CUDA-graph replay; launches from the "
               f"validation path (phase 6b: one a batch and metric, 2 sweeps of 2 batches, mAP and COCO AP); "
               f"max_abs_err 0: hits bit-equal to the plain version's; library_ms null: no PyTorch call computes "
               f"the greedy walk",
        "others": [{k: c[k] for k in ("label", "problems", "ranks", "targets", "thresholds", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "hits", "ranks_used")} for c in v["greedy_cells"][1:]],
        "config_2": {"launches": c2["evaluate"]["greedy_launches"],
                     "per": f"infer.evaluate at {C2_LABEL}: {C2_VALID_IMAGES // C2_B} batches, mAP and COCO AP"},
        "config_1": {"launches": c1["evaluate"]["greedy_launches"],
                     "per": f"infer.evaluate --model ssd at {C1_LABEL}: {C1_VALID_IMAGES // C1_B} batches"},
        "traced_replayed_batch": v["destr"]["traced"]["greedy"],
    })
    entries.append({
        "name": "span_stamp", "route": "cuda", "source": SPAN_SOURCE,
        "replaces": "none: the JAX package has no spans inside its compiled step",
        "launches": stamp["launches"], "max_abs_err": None, "ms": stamp["ms"], "plain_ms": stamp["plain_ms"],
        "bound_ms": stamp["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "path_launches": stamp["path_launches"], "spins": stamp["spins"],
        "per": f"phase 23: launches from 0 at the phase's start ({stamp['eager_launches']} eager, "
               f"{stamp['capture_launches']} captured, {stamp['replay_launches']} from the replays), "
               f"path_launches: the earlier phases' (every DESTR path without a recorder); ms: one stamp, device "
               f"ms from CUDA-graph replay; plain_ms: the host's stamp; bound_ms: 16 bytes over HBM's rate, "
               f"the kernel is bound by latency; max_abs_err null: the two clocks differ, the written cells are "
               f"compared; spins: a stamp pair around a spin kernel against CUDA events inside it",
    })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
