"""object_detection_destr_tpu_torch — the PyTorch + CUDA port of
``object_detection_destr_tpu`` for NVIDIA Hopper (H100).

The file layout mirrors the JAX package, so each module names its
counterpart there; public layouts stay the JAX package's (NHWC images,
cxcyhw boxes with h before w, head-packed ``(B, S, h*d)`` attention
operands). This package imports ``torch`` and ``numpy`` and never JAX.

Subpackages:
    geometry  — box conversion and sine embeddings
    ops       — attention, focal terms, the auction, masked top-k, and the
                hand-written CUDA kernels
    models    — ResNet backbone, the DESTR split transformer, weight import
    losses    — the matcher and the set criterion
    data      — synthetic dataset, batching loader, train / inference transforms
    train     — optimizer, train state and step, the training driver and CLI
    infer     — DESTR post-processing and the HTTP detection service
"""

__version__ = "0.1.0"
