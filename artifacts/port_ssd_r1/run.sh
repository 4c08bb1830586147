#!/usr/bin/env bash
# scripts/train_prod_ssd.sh's recipe (SSD300-VGG16, B=32, 300px, bf16, 20
# classes, paper mining, lr 1e-4 with 500 warm-up steps, --skip_nonfinite 100,
# the set on the device) on the PyTorch port, with the JAX run's segment-1
# flags --ema_decay 0.999 --epoch_scan and its validation every 5 epochs
# (artifacts/prod_r5_ssd/metrics.jsonl validates at steps 640 and 1280),
# cut to EPOCHS epochs (default 12: that segment's 1,536 steps).
#
# Usage: artifacts/port_ssd_r1/run.sh LOG_DIR CHECKPOINT_DIR [EPOCHS]
#   LOG_DIR/metrics.jsonl is what artifacts/port_ssd_r1/compare.py reads.
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m object_detection_destr_tpu_torch.train.train_ssd \
    --dataset synthetic --synthetic_size 384 \
    --num_train_samples 4096 --num_valid_samples 512 --augment_factor 1 \
    --batch_size 32 --compute_dtype bfloat16 --num_cls 20 \
    --hard_neg_mining paper \
    --epochs "${3:-12}" --lr 1e-4 --lr_backbone 1e-4 --lr_drop 240 \
    --lr_warmup_steps 500 --skip_nonfinite 100 \
    --device_cache --ema_decay 0.999 --epoch_scan --val_interval 5 \
    --save_as port_ssd_r1 --checkpoint_dir "$2" --log_dir "$1" --log_interval 32
