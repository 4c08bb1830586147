#!/usr/bin/env bash
# The production DESTR recipe on the PyTorch port, the counterpart of
# scripts/train_prod_synth.sh: the same flags, letter for letter, into
# object_detection_destr_tpu_torch.train.train, which runs on the GPU unless
# --device cpu is given.
#
# Full DESTR at 640px, 6+6 blocks, top_k 300, bf16, on 2048 synthetic
# training images generated at 672px and served from device memory
# (--device_cache): lr 1e-4 (backbone 1e-5) with a 1000-step warm-up and a
# 10x drop at epoch 90, the boxes-normalized class loss with L1 weight 2.5,
# global-norm clip 0.1, non-finite updates skipped, a parameter EMA of decay
# 0.999 and COCO AP at every validation. scripts/train_prod_synth.sh says
# why each flag is there.
#
# Flags given here come last and win: --epoch_scan runs each epoch as
# replays of one captured CUDA-graph step; --epochs N with --resume runs N
# more epochs from the checkpoint.
#
# Usage: scripts/train_prod_synth_torch.sh [extra flags...]
#   e.g. scripts/train_prod_synth_torch.sh --epoch_scan --epochs 40 --resume --resume_from prod_r4_last
set -euo pipefail
cd "$(dirname "$0")/.."

exec python -m object_detection_destr_tpu_torch.train.train \
    --dataset synthetic --synthetic_size 672 \
    --num_train_samples 2048 --num_valid_samples 256 --augment_factor 1 \
    --image_size 640 --batch_size 16 --compute_dtype bfloat16 \
    --num_encoder_blocks 6 --num_decoder_blocks 6 --top_k 300 \
    --epochs 120 --lr 1e-4 --lr_backbone 1e-5 --lr_drop 90 \
    --lr_warmup_steps 1000 --ema_decay 0.999 \
    --class_norm boxes --set_cost_class 1 --set_cost_bbox 2.5 \
    --set_cost_ciou 1 --grad_clip_norm 0.1 --skip_nonfinite 100 \
    --device_cache --coco_eval --save_as prod_r4 \
    --checkpoint_dir checkpoints_prod --log_dir runs_prod \
    --log_interval 32 \
    "$@"
