#!/usr/bin/env bash
# DESTR training launcher of the PyTorch port, the counterpart of
# scripts/train_destr.sh: flags forward straight into the port's training
# module, object_detection_destr_tpu_torch.train.train, which runs on the
# GPU unless --device cpu is given.
set -euo pipefail

ARGS=()
usage() {
  sed -n '2,5p' "$0"
  cd "$(dirname "$0")/.."
  python -m object_detection_destr_tpu_torch.train.train --help
  exit 0
}

while [[ $# -gt 0 ]]; do
  case "$1" in
    -h|--help) usage ;;
    *) ARGS+=("$1"); shift ;;
  esac
done

cd "$(dirname "$0")/.."
exec python -m object_detection_destr_tpu_torch.train.train "${ARGS[@]}"
