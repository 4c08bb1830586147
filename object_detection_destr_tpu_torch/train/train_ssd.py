"""SSD training entry point (port of ``object_detection_destr_tpu/train/train_ssd.py``):

    python -m object_detection_destr_tpu_torch.train.train_ssd --epochs 10 --dataset synthetic

Runs on the GPU; ``--device cpu`` runs on the CPU. The extra-block pyramid
closes only at ``--image_size 300`` (the default).
"""

from __future__ import annotations

from ..parallel.mesh import launched
from .arg_parser import config_from_args, get_parser
from .driver import train_ssd


def main(argv=None) -> dict:
    args = get_parser("ssd").parse_args(argv)
    config = config_from_args(args, "ssd")
    with launched(args.device) as device:
        return train_ssd(config, device=device)


if __name__ == "__main__":
    main()
