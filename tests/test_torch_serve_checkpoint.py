"""The port's server serves the port's own checkpoints, as the JAX package's
server (``infer/server.py::build_service``, l.198-201) serves a checkpoint of
its own trainer.

A tiny float32 CPU run of ``train.train.main`` saves ``served``
(``--save_as``) at the end of its one epoch. ``build_service(--weights served)`` must restore
that checkpoint, also from its ``.new`` or ``.old`` stage (the names a
crash inside a save leaves), and answer a request with the detections of
the trained model's own forward on the same letterboxed image. Both run in
float32 on the CPU from the same weights, so the answers agree to rounding.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas
from object_detection_destr_tpu_torch.data.transforms import letterbox_infer_transform
from object_detection_destr_tpu_torch.infer.predict import destr_predict
from object_detection_destr_tpu_torch.infer.server import build_service, get_parser
from object_detection_destr_tpu_torch.train import train as train_cli

SIZE = 64
MODEL = ["--hidden_dim", "32", "--ffn_dim", "64", "--num_heads", "4", "--num_encoder_blocks", "2",
         "--num_decoder_blocks", "2", "--top_k", "4"]
RUN = ["--device", "cpu", "--epochs", "1", "--batch_size", "2", "--image_size", str(SIZE), "--synthetic_size", "67",
       "--num_train_samples", "4", "--num_valid_samples", "2", "--augment_factor", "1", "--log_interval", "1",
       "--lr", "1e-3", "--lr_backbone", "0", "--seed", "3", "--compute_dtype", "float32", "--save_as", "served"] + MODEL


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a tiny model: keep the other test workers' cores free
    try:
        ckpt = str(tmp_path_factory.mktemp("ckpt"))
        result = train_cli.main(RUN + ["--checkpoint_dir", ckpt, "--log_dir", ckpt])
    finally:
        torch.set_num_threads(threads)
    assert os.path.exists(os.path.join(ckpt, "served"))
    return result["state"].model.eval(), ckpt


def _own_detections(model, image):
    canvas, fh, fw = _letterbox_canvas(image, SIZE)
    prep = letterbox_infer_transform(torch.from_numpy(canvas[None]), torch.tensor([[fh, fw]], dtype=torch.float32),
                                     out_size=SIZE)
    with torch.inference_mode():
        outputs, _ = model(prep["images"], valid_mask=prep["pixel_valid"])
    dets = {k: v.numpy() for k, v in destr_predict(outputs, score_thresh=0.0).items()}
    keep = dets["valid"][0]
    scale = np.asarray([fw, fh, fw, fh], np.float32)
    return np.clip(dets["boxes"][0][keep] / scale, 0.0, 1.0), dets["scores"][0][keep], dets["labels"][0][keep]


@pytest.mark.parametrize("stage", ["", ".new", ".old"])
def test_server_serves_the_trainers_checkpoint(trained, tmp_path, stage):
    model, ckpt = trained
    shutil.copy(os.path.join(ckpt, "served"), os.path.join(tmp_path, "served" + stage))
    args = get_parser().parse_args(["--checkpoint_dir", str(tmp_path), "--weights", "served", "--device", "cpu",
                                    "--image_size", str(SIZE), "--score_thresh", "0.0"] + MODEL)
    service = build_service(args)
    image = np.random.default_rng(7).integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    det = service.predict_image(image)
    boxes, scores, labels = _own_detections(model, image)
    assert len(det["boxes"]) == len(boxes) == 4
    assert det["labels"] == labels.tolist()
    np.testing.assert_allclose(det["scores"], scores, atol=1e-6)
    np.testing.assert_allclose(det["boxes"], boxes, atol=1e-6)
