#!/usr/bin/env bash
# The prod_r5 run's recipe (artifacts/prod_r5/RUNLOG.md: scripts/train_prod_synth.sh
# at its r4 defaults, --lr_backbone 1e-4, no --ema_decay) on the PyTorch port,
# with --device_cache and --epoch_scan, cut to EPOCHS epochs (default 30).
#
# Usage: artifacts/port_prod_r1/run.sh LOG_DIR CHECKPOINT_DIR [EPOCHS]
#   LOG_DIR/metrics.jsonl is what artifacts/port_prod_r1/compare.py reads.
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m object_detection_destr_tpu_torch.train.train \
    --dataset synthetic --synthetic_size 672 \
    --num_train_samples 2048 --num_valid_samples 256 --augment_factor 1 \
    --image_size 640 --batch_size 16 --compute_dtype bfloat16 \
    --num_encoder_blocks 6 --num_decoder_blocks 6 --top_k 300 \
    --epochs "${3:-30}" --lr 1e-4 --lr_backbone 1e-4 --lr_drop 90 \
    --lr_warmup_steps 1000 \
    --class_norm boxes --set_cost_class 1 --set_cost_bbox 2.5 \
    --set_cost_ciou 1 --grad_clip_norm 0.1 --skip_nonfinite 100 \
    --device_cache --epoch_scan --coco_eval --save_as port_prod_r1 \
    --checkpoint_dir "$2" --log_dir "$1" --log_interval 32
