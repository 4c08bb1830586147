#!/usr/bin/env bash
# The production SSD recipe on the PyTorch port, the counterpart of
# scripts/train_prod_ssd.sh: the same flags, letter for letter, into
# object_detection_destr_tpu_torch.train.train_ssd, which runs on the GPU
# unless --device cpu is given.
#
# Full SSD-VGG16 at 300px, batch 32, bf16, on 4096 synthetic training
# images of 20 classes generated at 384px (300 x 1.28, the random patch's
# headroom) and served from device memory: the SSD paper's hard-negative
# mining, lr 1e-4 AdamW from scratch with a 500-step warm-up and a 10x drop
# at epoch 240, non-finite updates skipped. scripts/train_prod_ssd.sh says
# why each flag is there.
#
# Usage: scripts/train_prod_ssd_torch.sh [extra flags...]
#   e.g. scripts/train_prod_ssd_torch.sh --epochs 40 --resume --resume_from ssd_prod_last
set -euo pipefail
cd "$(dirname "$0")/.."

exec python -m object_detection_destr_tpu_torch.train.train_ssd \
    --dataset synthetic --synthetic_size 384 \
    --num_train_samples 4096 --num_valid_samples 512 --augment_factor 1 \
    --batch_size 32 --compute_dtype bfloat16 --num_cls 20 \
    --hard_neg_mining paper \
    --epochs 300 --lr 1e-4 --lr_backbone 1e-4 --lr_drop 240 \
    --lr_warmup_steps 500 --skip_nonfinite 100 \
    --device_cache --save_as ssd_prod \
    --checkpoint_dir checkpoints_prod --log_dir runs_prod_ssd \
    --log_interval 32 \
    "$@"
