"""Import a torch backbone checkpoint into a train checkpoint of the port
(port of ``object_detection_destr_tpu/models/import_weights.py``).

The reference gets ImageNet weights from torchvision (backbone.py:139,
model_ssd.py:141). A user exports them once on any machine with
torchvision::

    import torch, torchvision, numpy as np
    sd = torchvision.models.resnet50(weights="IMAGENET1K_V1").state_dict()
    np.savez("resnet50.npz", **{k: v.numpy() for k, v in sd.items()})

(or ``torch.save(sd, "resnet50.pth")``) and imports here::

    python -m object_detection_destr_tpu_torch.models.import_weights \\
        --model destr --weights resnet50.npz \\
        --checkpoint_dir checkpoints --save_as pretrained

which writes a full train checkpoint (``train/checkpoint.py``) whose backbone
carries the torch weights and whose other parameters are freshly initialized
from ``--seed``'s default (0), at loader position epoch 0, step 0: ready for
``train.train`` (or ``train.train_ssd`` after ``--model ssd --weights
vgg16.pth``) with ``--resume --resume_from pretrained``. The model is built
on the GPU unless ``--device cpu`` is given. The train run must use this
import's model-shape flags, its ``--lr_backbone`` on the same side of 0 (0
keeps no backbone moments) and the defaults of ``--opt_layout``,
``--moment_dtype`` and ``--grad_accum_steps``, because a resume restores the
optimizer's state as it was written.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import DestrConfig, SSDConfig, TrainConfig, resolve_device
from ..train.checkpoint import save_checkpoint
from .convert import load_flax_variables, resnet_params_from_torch, vgg16_params_from_torch

__all__ = ["get_parser", "main"]


def _load_state_dict(path: str) -> dict:
    """A state dict from ``.npz`` or from a torch file (``.pt`` / ``.pth``,
    read with ``weights_only=True``; a saved module gives its ``state_dict``),
    as numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def get_parser() -> argparse.ArgumentParser:
    """The JAX package's flags and defaults (import_weights.py:44-72), and
    ``--device``."""
    p = argparse.ArgumentParser("object_detection_destr_tpu_torch import_weights")
    p.add_argument("--model", choices=["destr", "ssd"], default="destr")
    p.add_argument("--weights", required=True, help=".npz or torch .pth state dict")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--save_as", type=str, default="pretrained")
    p.add_argument("--backbone", type=str, default="resnet50",
                   choices=["resnet50", "resnet101"])
    p.add_argument("--image_size", type=int, default=None,
                   help="accepted for the JAX package's command lines; changes nothing (the port's "
                        "state needs no input shape)")
    # model-shape flags (must match the later train run so the checkpoint's
    # state lines up at --resume time); defaults mirror the train CLI
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--ffn_dim", type=int, default=2048)
    p.add_argument("--num_encoder_blocks", type=int, default=6)
    p.add_argument("--num_decoder_blocks", type=int, default=6)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--num_cls", type=int, default=None,
                   help="defaults: 2 for destr, 20 for ssd")
    p.add_argument("--dilation", action="store_true")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr_backbone", type=float, default=1e-4,
                   help="0 keeps no moments for the backbone, > 0 keeps them: the train run's "
                        "--lr_backbone must be on the same side of 0")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU ('cpu' must be asked for)")
    return p


def main(argv=None) -> str:
    """Write the checkpoint; returns its path."""
    from ..train.state import create_destr_state, create_ssd_state
    from .destr.model import build_destr
    from .ssd.model import build_ssd

    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    sd = _load_state_dict(args.weights)
    train_cfg = TrainConfig(lr=args.lr, lr_backbone=args.lr_backbone)
    torch.manual_seed(train_cfg.seed)  # the other parameters start as the trainer's would

    if args.model == "destr":
        cfg = DestrConfig(
            backbone=args.backbone,
            dilation=args.dilation,
            hidden_dim=args.hidden_dim,
            num_heads=args.num_heads,
            ffn_dim=args.ffn_dim,
            num_encoder_blocks=args.num_encoder_blocks,
            num_decoder_blocks=args.num_decoder_blocks,
            top_k=args.top_k,
            num_cls=args.num_cls or 2,
        )
        state = create_destr_state(build_destr(cfg, device), train_cfg)
        stage_sizes = (3, 4, 6, 3) if args.backbone == "resnet50" else (3, 4, 23, 3)
        backbone = resnet_params_from_torch(sd, stage_sizes)
    else:
        state = create_ssd_state(build_ssd(SSDConfig(num_cls=args.num_cls or 20), device), train_cfg)
        backbone = vgg16_params_from_torch(sd)

    load_flax_variables(state.model.backbone, {"params": backbone})
    path = save_checkpoint(args.checkpoint_dir, args.save_as, state, {"epoch": 0, "step": 0})
    print(f"imported {args.model} backbone weights -> {path}")
    return path


if __name__ == "__main__":
    main()
