"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/destr/layers.py`` l.1-229, its kernels replaced by their plain versions and its data-parallel paths left out.]

Shared building blocks of the DESTR transformer (port of
``object_detection_destr_tpu/models/destr/layers.py``), and the dropout
stream a training step hands the model."""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .attention import scaled_dot_product_attention, split_heads
from .flash_plain import packed_attention as flash_attention_packed

__all__ = [
    "DropoutRng",
    "LearnedPositionEmbedding",
    "Mlp",
    "MultiHeadAttention",
    "attention_dropout_seed",
    "checkpointed",
    "dropout",
    "f32_head",
    "layer_norm",
]


class DropoutRng:
    """The dropout stream of a training run: one generator on the model's
    device draws the elementwise dropout masks and the flash kernels' seeds.
    ``begin_step(step)`` reseeds it from (seed, step), so a step's draws are
    a pure function of both, as ``fold_in(rng, step)`` makes them in the JAX
    package: a resumed run draws what the uninterrupted one did, and a CUDA
    graph that registers :attr:`generator` (``train/epoch_scan.py``) draws
    in a replay what the eager step draws at the same step. ``None`` in its
    place means eval: every dropout is the identity.

    Every draw goes through :meth:`seed` or :meth:`keep_mask`, so that
    :meth:`taped` can hand a recomputed block the draws of its first run
    (activation checkpointing, :func:`checkpointed`)."""

    def __init__(self, seed: int, device: str | torch.device = "cpu"):
        self.base_seed = seed
        self.generator = torch.Generator(device=torch.device(device))
        self._tape: Optional[list] = None  # draws recorded or replayed inside ``taped``
        self._replay = False
        self._pos = 0
        self.begin_step(0)

    def begin_step(self, step: int, rank: Optional[int] = None) -> None:
        """Reseed for train step ``step`` (a host call; nothing waits for the
        device). A rank of a data axis above 1 passes its index, which goes
        into the seed as ``fold_in(step_rng, axis_index)`` does (JAX
        steps.py:195, 290), so the ranks draw distinct masks; ``None`` (one
        device, or an axis of 1) keeps the single device's seed."""
        self.generator.manual_seed((self.base_seed + 1) * 1_000_003 + step)

    def _draw(self, make) -> torch.Tensor:
        if self._tape is None:
            return make()
        if self._replay:
            self._pos += 1
            return self._tape[self._pos - 1]
        drawn = make()
        self._tape.append(drawn)
        return drawn

    def seed(self) -> torch.Tensor:
        """A fresh flash-kernel seed, a (1,) int64 tensor on the generator's
        device that the kernels read there (layers.py:22-33 draws one per
        call)."""
        return self._draw(lambda: torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                                                device=self.generator.device))

    def keep_mask(self, shape, rate: float, device: torch.device) -> torch.Tensor:
        """A bool mask of ``shape``, each element True with probability
        ``1 - rate``."""
        return self._draw(lambda: torch.rand(shape, generator=self.generator, device=device) < 1.0 - rate)

    @contextlib.contextmanager
    def taped(self, tape: list, replay: bool):
        """Inside the block, record every draw into ``tape`` or, with
        ``replay``, return the recorded draws in their order instead of
        drawing: a recomputation sees the masks and seeds of the first run."""
        if self._tape is not None:
            raise RuntimeError("DropoutRng.taped does not nest")
        self._tape, self._replay, self._pos = tape, replay, 0
        try:
            yield
        finally:
            self._tape, self._replay = None, False


def checkpointed(block: nn.Module, rng: Optional[DropoutRng], *args) -> torch.Tensor:
    """``block(*args, rng)`` under activation checkpointing (``nn.remat`` in
    the JAX package, encoder.py:78, decoder.py:219-221): its activations are
    dropped after the forward and recomputed in the backward.

    ``torch.utils.checkpoint``'s ``preserve_rng_state`` restores only the
    default CPU and CUDA generators, and the blocks draw from ``rng``'s own:
    the recomputation would draw new dropout masks and kernel seeds and give
    a wrong gradient without an error. So the forward records its draws
    (bool masks and seeds, kept until the backward) and the recomputation
    replays them; nothing reads or sets a generator's state, which a CUDA
    graph capture would not allow, so ``preserve_rng_state`` is off."""
    tape: list = []
    runs = [0]

    def run(*inputs):
        replay = runs[0] > 0
        runs[0] += 1
        if rng is None:
            return block(*inputs, None)
        with rng.taped(tape, replay):
            return block(*inputs, rng)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the identity without a stream or at rate 0."""
    if rng is None or rate <= 0.0:
        return x
    keep = rng.keep_mask(x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def attention_dropout_seed(rate: float, rng: Optional[DropoutRng]) -> tuple[float, Optional[torch.Tensor]]:
    """(rate, seed) for the flash kernel's in-kernel dropout; (0, None) in eval."""
    if rng is None or rate <= 0.0:
        return 0.0, None
    return rate, rng.seed()


def autocast(device_type: str, **kwargs):
    """``torch.autocast``, and nothing on the meta device (where the
    reference's operations are counted), which autocast does not take."""
    if device_type == "meta":
        return contextlib.nullcontext()
    return torch.autocast(device_type, **kwargs)


def f32_head(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Run a shared head in float32 whatever the compute dtype: the JAX
    package keeps cls_embed, bbox_embed and pos_head in float32 (model.py:118-119)."""
    with autocast(x.device.type, enabled=False):
        return module(x.float())


def layer_norm(features: int) -> nn.LayerNorm:
    """LayerNorm with flax's default eps of 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(features, eps=1e-6)


class LearnedPositionEmbedding(nn.Module):
    """Learned 2-D position embedding (layers.py:36-63): per pixel
    ``concat[col_embed(x), row_embed(y)]``, x first."""

    def __init__(self, num_pos_feats: int = 128, table_size: int = 50):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = nn.Embedding(table_size, num_pos_feats)
        self.col_embed = nn.Embedding(table_size, num_pos_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """Returns (H, W, 2 * num_pos_feats)."""
        device = self.row_embed.weight.device
        x_emb = self.col_embed(torch.arange(w, device=device))  # (W, d)
        y_emb = self.row_embed(torch.arange(h, device=device))  # (H, d)
        d = self.num_pos_feats
        return torch.cat(
            [x_emb[None, :, :].expand(h, w, d), y_emb[:, None, :].expand(h, w, d)], dim=-1
        )


class Mlp(nn.Module):
    """Linear stack with ReLU between layers, none after the last
    (layers.py:66-83); layers are named ``fc{i}``."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.num_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", nn.Linear(in_features, f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Batch-first MHA with q/k/v/out projections (layers.py:86-137).

    ``use_flash`` routes the head-packed operands through the flash-attention
    wrapper (the CUDA kernel for CUDA tensors); otherwise heads are split and
    ops/attention.py computes the same function.
    """

    def __init__(self, hidden_dim: int, num_heads: int, use_flash: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dropout = dropout
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_valid_mask: Optional[torch.Tensor] = None,
        rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        if self.use_flash:
            rate, seed = attention_dropout_seed(self.dropout, rng)
            out = flash_attention_packed(q, k, v, self.num_heads, key_valid_mask, rate, seed)
        else:
            h = self.num_heads
            out = scaled_dot_product_attention(
                split_heads(q, h), split_heads(k, h), split_heads(v, h),
                key_valid_mask=key_valid_mask, dropout_rate=self.dropout, dropout_rng=rng,
            )
        return self.out_proj(out)
