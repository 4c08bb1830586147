"""The training entry point under a launcher: ``python -m
object_detection_destr_tpu_torch.train.train --device cpu --num_data_shards
2`` as two processes with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), gloo on the CPU, on the
tiny config for one epoch.

Each process starts a process group of its own (``start_new_session``),
has a timeout of 120 s, and is killed with its group in a ``finally``. Each
rank is given its own checkpoint and log directories, so the test sees that
rank 0 alone writes. The validation sweep gathers each batch's outputs and
targets to every rank, so the mAP rank 0 logs is the one ``infer.evaluate``
computes in one process on rank 0's checkpoint. What the two ranks' step
computes is held in ``tests/test_torch_parallel.py``.
"""

import json
import os
import signal
import socket
import subprocess
import sys

from object_detection_destr_tpu_torch.infer import evaluate
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["--device", "cpu", "--epochs", "1", "--batch_size", "2", "--image_size", "64", "--synthetic_size", "67",
       "--num_train_samples", "2", "--num_valid_samples", "2", "--augment_factor", "1", "--log_interval", "1",
       "--lr", "1e-3", "--lr_backbone", "0", "--seed", "3", "--compute_dtype", "float32",
       "--hidden_dim", "32", "--ffn_dim", "64", "--num_heads", "4", "--num_encoder_blocks", "1",
       "--num_decoder_blocks", "1", "--top_k", "4", "--save_as", "dp"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_launcher_ranks_train_as_one_process(tmp_path):
    port, procs, outs = _free_port(), [], []
    try:
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "2",
                   "PYTHONPATH": REPO}
            args = RUN + ["--num_data_shards", "2", "--checkpoint_dir", str(tmp_path / f"ckpt{rank}"),
                          "--log_dir", str(tmp_path / f"log{rank}")]
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "object_detection_destr_tpu_torch.train.train", *args], cwd=REPO, env=env,
                start_new_session=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for proc in procs:
            outs.append(proc.communicate(timeout=120)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]

    # rank 0 alone printed, logged and saved
    assert "epoch 0:" in outs[0] and "epoch 0:" not in outs[1]
    assert os.path.exists(tmp_path / "ckpt0" / "dp_last") and os.path.exists(tmp_path / "ckpt0" / "dp")
    records = [json.loads(line) for line in open(tmp_path / "log0" / "metrics.jsonl")]
    assert any(r.get("tag") == "Metric/mAP" for r in records)
    assert not os.path.exists(tmp_path / "ckpt1") and not os.path.exists(tmp_path / "log1")

    logged = {r["tag"]: r["value"] for r in records if "tag" in r}
    ours = evaluate.main(RUN + ["--checkpoint_dir", str(tmp_path / "ckpt0"), "--log_dir", "", "--resume_from",
                                "dp_last"])
    assert logged["Metric/mAP"] == ours["map"] and ours["n_images"] == 2
