#!/usr/bin/env bash
# The run of record of the production DESTR recipe on the PyTorch port:
# scripts/train_prod_synth_torch.sh with --epoch_scan for its 120 epochs, in
# three segments of 40 epochs, the second and third resumed from the first's
# and second's port_prod_r2_last checkpoint; then infer.evaluate on the
# best-val (port_prod_r2) and best-EMA-val (port_prod_r2_ema) checkpoints at
# 256 and 1024 validation images, and tools/val_noise_torch.py on the
# best-val one at 256.
#
# Usage: artifacts/port_prod_r2/run.sh OUT_DIR CHECKPOINT_DIR [extra flags...]
#   OUT_DIR receives metrics.jsonl (one stream across the segments),
#   train.log, segments.jsonl (each segment's command and seconds, the card),
#   eval_port_prod_r2{,_ema}_nv{256,1024}.json and
#   val_noise_port_prod_r2_nv256.json. Extra flags go last on every command
#   (e.g. --device cpu and small shape flags for a rehearsal on the CPU).
set -euo pipefail
cd "$(dirname "$0")/../.."
out=$1 ckpt=$2
shift 2
mkdir -p "$out" "$ckpt"
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null | head -n 1 || echo cpu)

segment() {
  local t0=$SECONDS
  local cmd=(scripts/train_prod_synth_torch.sh --epoch_scan --epochs 40 --save_as port_prod_r2
             --checkpoint_dir "$ckpt" --log_dir "$out" "$@")
  "${cmd[@]}" 2>&1 | tee -a "$out/train.log"
  python3 -c 'import json, sys; print(json.dumps({"command": sys.argv[3:], "seconds": int(sys.argv[1]), "card": sys.argv[2]}))' \
    "$((SECONDS - t0))" "$card" "${cmd[@]}" >> "$out/segments.jsonl"
}

segment "$@"
segment --resume --resume_from port_prod_r2_last "$@"
segment --resume --resume_from port_prod_r2_last "$@"

# the recipe's flags that the evaluator and the val-noise tool read
eval_flags=(--dataset synthetic --synthetic_size 672 --augment_factor 1
            --image_size 640 --batch_size 16 --compute_dtype bfloat16
            --num_encoder_blocks 6 --num_decoder_blocks 6 --top_k 300
            --checkpoint_dir "$ckpt")
for name in port_prod_r2 port_prod_r2_ema; do
  for nv in 256 1024; do
    python -m object_detection_destr_tpu_torch.infer.evaluate "${eval_flags[@]}" \
      --resume_from "$name" --num_valid_samples "$nv" "$@" | tail -n 1 > "$out/eval_${name}_nv${nv}.json"
    cat "$out/eval_${name}_nv${nv}.json"
  done
done
python tools/val_noise_torch.py "${eval_flags[@]}" --resume_from port_prod_r2 --num_valid_samples 256 "$@" \
  | tail -n 1 > "$out/val_noise_port_prod_r2_nv256.json"
cat "$out/val_noise_port_prod_r2_nv256.json"
