#!/usr/bin/env bash
# SSD training launcher of the PyTorch port, the counterpart of
# scripts/train_ssd.sh: flags forward into the port's training module,
# object_detection_destr_tpu_torch.train.train_ssd (the GPU unless --device cpu).
set -euo pipefail

ARGS=()
usage() {
  sed -n '2,4p' "$0"
  cd "$(dirname "$0")/.."
  python -m object_detection_destr_tpu_torch.train.train_ssd --help
  exit 0
}

while [[ $# -gt 0 ]]; do
  case "$1" in
    -h|--help) usage ;;
    *) ARGS+=("$1"); shift ;;
  esac
done

cd "$(dirname "$0")/.."
exec python -m object_detection_destr_tpu_torch.train.train_ssd "${ARGS[@]}"
