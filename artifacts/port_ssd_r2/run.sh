#!/usr/bin/env bash
# SSD's run of record on the PyTorch port: scripts/train_prod_ssd_torch.sh
# with --epoch_scan in the three segments of the JAX run of record
# (artifacts/prod_r5_ssd/metrics.jsonl: a new process at steps 1664 and 7040),
# the second and third resumed from the previous one's port_ssd_r2_last:
#   1. 13 epochs (steps 1-1664), lr 1e-4, EMA 0.999;
#   2. 42 epochs (steps 1665-7040), lr 1e-4, no EMA;
#   3. 60 epochs (steps 7041-14720), lr 3e-5, no EMA;
# each validating every 5 of its epochs, as the JAX segments did (640, 1280;
# 2304 ... 6784; 7680 ... 14720), and at its last epoch (the port's driver
# validates there; the JAX segments 1 and 2 were interrupted before it).
# Then infer.evaluate --model ssd re-scores the last (port_ssd_r2_last) and
# best-val (port_ssd_r2) checkpoints on the recipe's 512 validation images.
#
# Usage: artifacts/port_ssd_r2/run.sh OUT_DIR CHECKPOINT_DIR [extra flags...]
#   OUT_DIR receives metrics.jsonl (one stream across the segments), train.log,
#   segments.jsonl (each segment's command, seconds and card, and the step,
#   loader state and best val loss in its _last and best checkpoints) and
#   eval_port_ssd_r2_{last,best}.json. Extra flags go last on every command
#   (e.g. --device cpu and a small set for a rehearsal on the CPU).
set -euo pipefail
cd "$(dirname "$0")/../.."
out=$1 ckpt=$2
shift 2
mkdir -p "$out" "$ckpt"
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null | head -n 1 || echo cpu)

segment() {
  local t0=$SECONDS
  local cmd=(scripts/train_prod_ssd_torch.sh --epoch_scan --val_interval 5 --save_as port_ssd_r2
             --checkpoint_dir "$ckpt" --log_dir "$out" "$@")
  "${cmd[@]}" 2>&1 | tee -a "$out/train.log"
  python3 - "$((SECONDS - t0))" "$card" "$ckpt" "${cmd[@]}" >> "$out/segments.jsonl" <<'PY'
import json, os, sys

import torch

seconds, card, ckpt, cmd = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:]
saved = {}
for name in ("port_ssd_r2_last", "port_ssd_r2"):
    path = os.path.join(ckpt, name)
    if os.path.exists(path):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        saved[name] = {"step": raw["step"], "loader": raw["loader"], "best_val": raw["best_val"]}
print(json.dumps({"command": cmd, "seconds": seconds, "card": card, "checkpoints": saved}))
PY
  tail -n 1 "$out/segments.jsonl"
}

segment --epochs 13 --lr 1e-4 --ema_decay 0.999 "$@"
segment --epochs 42 --lr 1e-4 --resume --resume_from port_ssd_r2_last "$@"
segment --epochs 60 --lr 3e-5 --resume --resume_from port_ssd_r2_last "$@"

# the recipe's flags that the evaluator reads (scripts/train_prod_ssd_torch.sh)
eval_flags=(--model ssd --dataset synthetic --synthetic_size 384 --num_train_samples 4096
            --num_valid_samples 512 --augment_factor 1 --batch_size 32 --compute_dtype bfloat16
            --num_cls 20 --hard_neg_mining paper --checkpoint_dir "$ckpt")
for pair in last:port_ssd_r2_last best:port_ssd_r2; do
  python -m object_detection_destr_tpu_torch.infer.evaluate "${eval_flags[@]}" --resume_from "${pair#*:}" "$@" \
    | tail -n 1 > "$out/eval_port_ssd_r2_${pair%%:*}.json"
  cat "$out/eval_port_ssd_r2_${pair%%:*}.json"
done
