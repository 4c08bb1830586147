"""Convert a checkpoint of the JAX package's trainer (Orbax) into the weights
file of the PyTorch port: the flax ``{"params", "batch_stats"}`` tree with
``/``-joined keys in one ``.npz`` (``object_detection_destr_tpu_torch/models/
convert.py::save_variables_npz``), for DESTR and SSD alike.

The checkpoint is read with the JAX package's own ``train/checkpoint.py::
restore_for_inference`` (its ``name``, ``name.new`` or ``name.old``, every
leaf restored as host numpy whatever devices wrote it), so this tool needs
JAX and Orbax; the port reads the result without either:

    python tools/orbax_to_npz.py --checkpoint_dir checkpoints --name model_weights \\
        --output weights/model_weights.npz
    python -m object_detection_destr_tpu_torch.infer.server --checkpoint_dir weights \\
        --weights model_weights.npz

It prints one JSON line: the output path, the leaves written and their
parameter count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from object_detection_destr_tpu.train.checkpoint import restore_for_inference  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import save_variables_npz  # noqa: E402


def convert(checkpoint_dir: str, name: str, output: str) -> dict:
    """Write checkpoint ``checkpoint_dir/name``'s model variables to ``output``."""
    variables = restore_for_inference(checkpoint_dir, name)
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    save_variables_npz(variables, output)
    with np.load(output) as data:
        return {"output": os.path.abspath(output), "leaves": len(data.files),
                "parameters": int(sum(data[k].size for k in data.files if k.startswith("params/")))}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", required=True, help="the JAX trainer's --checkpoint_dir")
    p.add_argument("--name", default="model_weights", help="the checkpoint's name (--save_as, _ema, _last)")
    p.add_argument("--output", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    result = convert(args.checkpoint_dir, args.name, args.output)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
