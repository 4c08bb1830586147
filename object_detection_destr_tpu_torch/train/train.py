"""DESTR training entry point (port of ``object_detection_destr_tpu/train/train.py``):

    python -m object_detection_destr_tpu_torch.train.train --epochs 10 --dataset synthetic

Runs on the GPU; ``--device cpu`` runs on the CPU (the kernels' plain
versions stand in for them there).
"""

from __future__ import annotations

from ..parallel.mesh import launched
from .arg_parser import config_from_args, get_parser
from .driver import train_destr


def main(argv=None) -> dict:
    args = get_parser("destr").parse_args(argv)
    config = config_from_args(args, "destr")
    with launched(args.device) as device:
        return train_destr(config, device=device)


if __name__ == "__main__":
    main()
