"""The reference's runs: the first training steps of a cell, from the seed
and the raw inputs alone, and the operation count of the model
(``torch.utils.flop_counter``) on the meta device.

``lower`` computes the reference one precision below the configuration's
bfloat16 (the control of the comparison): "fp8" rounds the operands of every linear layer,
convolution and attention product to float8 e4m3 and the gradients that
flow back into them to e5m2, as float8 training does; "int8" rounds both
to int8. Each tensor is scaled to the format's range."""

from __future__ import annotations

import contextlib
import types
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import flash_plain
from .criterion import set_criterion
from .data import coco_items, decode, padded_targets, resize_canvas
from .layers import DropoutRng
from .matcher import match_pair
from .model import DESTR
from .optim import AdamW
from .transforms import destr_train_transform
from .weights import seeded_weights

__all__ = ["build_model", "train_steps", "model_flops", "attention_work", "epoch_rows", "lower_precision"]

_MODEL_DEFAULTS = dict(pos_embed="sine", pair_mode="reference", pair_output_mode="reference", remat=False,
                       use_flash_attention=True, dilation=False)


def build_model(model_cfg: dict, compute_dtype: str, device) -> DESTR:
    """The reference DESTR of a configuration's ``model`` group."""
    cfg = types.SimpleNamespace(**{**_MODEL_DEFAULTS, **model_cfg, "compute_dtype": compute_dtype})
    with torch.device(device):
        return DESTR(cfg).eval()


_FORMATS = {  # the lower precisions of a bfloat16 configuration: forward operands, backward gradients
    "fp8": ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)),
    "int8": ((torch.int8, 127.0), (torch.int8, 127.0)),
}


def _rounded(x: torch.Tensor, fmt) -> torch.Tensor:
    """x rounded to ``fmt`` (dtype, largest value) at a per-tensor scale."""
    dtype, top = fmt
    scale = top / x.detach().abs().amax().float().clamp(min=1e-12)
    y = x.detach().float() * scale
    y = y.round().clamp(-top, top).to(dtype) if dtype == torch.int8 else y.to(dtype)
    return (y.float() / scale).to(x.dtype)


class _Lowered(torch.autograd.Function):
    """Forward: the operand rounded to the forward format; backward: the
    gradient rounded to the backward format (straight through otherwise)."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _rounded(x, _FORMATS[kind][0])

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, _FORMATS[ctx.kind][1]), None


def _lowered(kind: str):
    return lambda x: _Lowered.apply(x, kind)


@contextlib.contextmanager
def lower_precision(model: nn.Module, kind: Optional[str]):
    """Inside the block the model computes in ``kind`` (None: as configured)."""
    if kind is None:
        yield
        return
    if kind not in _FORMATS:
        raise ValueError(f"lower precision {kind!r}: 'fp8' or 'int8'")
    q = _lowered(kind)
    patched = []
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.forward = (lambda m: lambda x: F.linear(q(x), q(m.weight), m.bias))(module)
        elif isinstance(module, nn.Conv2d):
            module.forward = (lambda m: lambda x: m._conv_forward(q(x), q(m.weight), m.bias))(module)
        else:
            continue
        patched.append(module)
    flash_plain.OPERAND_ROUNDING = q
    try:
        yield
    finally:
        flash_plain.OPERAND_ROUNDING = None
        for module in patched:
            del module.forward


def epoch_rows(n_items: int, batch: int, seed: int, epoch: int = 0) -> np.ndarray:
    """The loader's batches of an epoch: a ``default_rng((seed, epoch))``
    shuffle of the items, cut into whole batches (n, B)."""
    order = np.arange(n_items)
    np.random.default_rng((seed, epoch)).shuffle(order)
    n = n_items // batch
    return order[:n * batch].reshape(n, batch).astype(np.int64)


def _leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def train_steps(cfg: dict, seed: int, root: str, rows: np.ndarray, device, lower: Optional[str] = None) -> dict:
    """The cell's first ``len(rows)`` training steps on the COCO tree at
    ``root``: {"loss", "loss_model", "loss_det": [each step's weighted
    losses], "grad": {leaf: norm of the first
    step's clipped gradient}, "change": {leaf: norm of the change after the
    last step}, "labels": {leaf: "main" | "backbone" | "frozen"}}."""
    m_cfg, t_cfg, d_cfg = cfg["model"], cfg["train"], cfg["data"]
    model = build_model(m_cfg, t_cfg["compute_dtype"], device)
    seeded_weights(model, seed)
    model.train()
    for p in model.parameters():
        p.requires_grad_(True)
    canvas = int(t_cfg["image_size"] * 672 / 640)
    steps_per_epoch = len(coco_items(root)) // t_cfg["batch_size"]
    opt = AdamW(model, t_cfg["lr"], t_cfg["lr_backbone"], t_cfg["lr_warmup_steps"],
                t_cfg["lr_drop"] * steps_per_epoch if t_cfg["lr_drop"] > 0 else 0, t_cfg["lr_drop_factor"],
                t_cfg["weight_decay"], grad_clip=t_cfg["grad_clip_norm"])
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    items = coco_items(root)
    rng = DropoutRng(seed, device)
    aug = torch.Generator(device=device)
    out = {"loss": [], "loss_model": [], "loss_det": [], "labels": dict(opt.labels)}
    with lower_precision(model, lower):
        for step, row in enumerate(rows):
            chosen = [items[i] for i in row]
            images = np.stack([resize_canvas(decode(path), canvas) for path, _, _ in chosen])
            tg = padded_targets([(b, lab) for _, b, lab in chosen], d_cfg["max_targets"])
            raw = {k: torch.from_numpy(v).to(device) for k, v in {"images": images, **tg}.items()}
            aug.manual_seed((seed + 7) * 1_000_003 + step)
            rng.begin_step(step)
            batch = destr_train_transform(raw["images"], raw["boxes"], raw["labels"], raw["valid"], aug,
                                          out_size=t_cfg["image_size"])
            targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
            opt.zero_grad()
            model_out, det_out = model(batch["images"], batch.get("pixel_valid"), train=True, rng=rng)
            rows_model, rows_det = match_pair(model_out, det_out, targets)
            weighted = lambda losses: (t_cfg["set_cost_class"] * losses["class"] + t_cfg["set_cost_bbox"]
                                       * losses["bbox"] + t_cfg["set_cost_ciou"] * losses["ciou"])
            l_model = set_criterion(model_out, targets, rows=rows_model, class_norm=t_cfg["class_norm"])
            l_det = set_criterion(det_out, targets, rows=rows_det, class_norm=t_cfg["class_norm"])
            loss_model, loss_det = weighted(l_model), weighted(l_det)
            loss = t_cfg["model_loss_weight"] * loss_model + t_cfg["det_loss_weight"] * loss_det
            loss.backward()
            opt.step()
            for k, v in (("loss", loss), ("loss_model", loss_model), ("loss_det", loss_det)):
                out[k].append(float(v.detach()))
            if step == 0:
                out["grad"] = _leaf_norms({k: m / (1.0 - opt.b1) for k, m in opt.m.items()})
    out["change"] = _leaf_norms({k: p.detach() - start[k] for k, p in model.named_parameters()})
    return out


def _meta_inputs(batch: int, size: int):
    images = torch.zeros((batch, size, size, 3), device="meta")
    valid = torch.ones((batch, size, size), dtype=torch.bool, device="meta")
    return images, valid


def model_flops(model_cfg: dict, batch: int, size: int, backward: bool) -> float:
    """The operations (FLOPs) of one forward at (batch, size, size), and of
    its backward with ``backward``, as ``FlopCounterMode`` counts the
    reference's matrix products and convolutions on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    model = build_model(model_cfg, "float32", "meta")
    images, valid = _meta_inputs(batch, size)
    if backward:
        model.train()
        for p in model.parameters():
            p.requires_grad_(True)
    counter = FlopCounterMode(display=False)
    with counter:
        with torch.set_grad_enabled(backward):
            model_out, det_out = model(images, valid, train=backward)
            if backward:
                (sum(v.sum() for v in model_out.values()) + sum(v.sum() for v in det_out.values())).backward()
    return float(counter.get_total_flops())


def attention_work(model_cfg: dict, batch: int, size: int, dtype: str) -> list[dict]:
    """The shape of each packed-attention call of one forward at (batch,
    size, size): {"b", "sq", "sk", "h", "d", "dv", "masked", "itemsize"}."""
    model = build_model(model_cfg, "float32", "meta")
    images, valid = _meta_inputs(batch, size)
    itemsize = {"float32": 4, "bfloat16": 2}[dtype]
    with torch.no_grad(), flash_plain.attention_sites() as sites:
        model(images, valid)
    return [{**s, "itemsize": itemsize} for s in sites]
