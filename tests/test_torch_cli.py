"""The port's batch prediction CLI on PNG files written to ``tmp_path``, for
both models, against the JAX package's predict path on the same weights
(random flax variables, saved for the port as the ``.npz`` it loads).

* SSD300 (its class heads scaled by 6, so that the random weights' scores
  spread up to 0.5 instead of sitting near 1/21; threshold 0.4): a 300 x
  300 image (no resize on either side, so both see the same pixels) through
  the JAX CLI's SSD body (``normalize_imagenet``, the model,
  ``ssd_predict``); a 200 x 260 image against the port's own server
  (``DetectionService.predict_image``, the stretch). Tolerances: counts
  equal, and each detection has one of the same label with scores and boxes
  within 1e-5 absolute (float32 VGG-16 summed in other orders; scores
  within 1e-5 of each other may swap places).
* DESTR (tiny: 64 px canvas, hidden 32, 2+2 blocks, top_k 4), letterboxed:
  images whose long side is the canvas, against the JAX ``DetectionService``
  with the tolerances of ``tests/test_torch_server.py`` (boxes 2e-3, scores
  1e-3, labels equal); ``--no-letterbox`` against the port's stretching
  server, equal within 1e-6.
* ``--draw`` writes one annotated PNG an image; without ``--device cpu`` on
  a host without CUDA the CLI raises.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import SSDConfig as JaxSSDConfig  # noqa: E402
from object_detection_destr_tpu.data.transforms import normalize_imagenet as jax_normalize  # noqa: E402
from object_detection_destr_tpu.infer.predict import ssd_predict as jax_ssd_predict  # noqa: E402
from object_detection_destr_tpu.infer.server import DetectionService as JaxService  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu.train.steps import flat_anchors as jax_flat_anchors  # noqa: E402
from object_detection_destr_tpu_torch.infer import cli, server  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import save_variables_npz  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from test_torch_server import FLAGS as DESTR_FLAGS, SIZE, TINY  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401


def _png(path, h, w, seed):
    image = np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    Image.fromarray(image).save(path)
    return image


def _same_set(rec, ref, tol):
    """Equal detections up to the order of near-equal scores."""
    assert len(rec["boxes"]) == len(ref["boxes"]) > 0
    ref_rows = np.concatenate([np.asarray(ref["boxes"]), np.asarray(ref["scores"])[:, None]], 1)
    for box, score, label in zip(rec["boxes"], rec["scores"], rec["labels"]):
        close = np.abs(ref_rows - np.asarray(box + [score])).max(1) <= tol
        assert (close & (np.asarray(ref["labels"]) == label)).sum() == 1, (box, score, label)


def _close(rec, ref, boxes_tol, scores_tol):
    assert len(rec["boxes"]) == len(ref["boxes"]) > 0
    assert rec["labels"] == list(ref["labels"])
    np.testing.assert_allclose(rec["scores"], ref["scores"], rtol=0, atol=scores_tol)
    np.testing.assert_allclose(rec["boxes"], ref["boxes"], rtol=0, atol=boxes_tol)


def test_cli_ssd(tmp_path):
    variables = _random_variables(jax_build_ssd(JaxSSDConfig()), np.random.default_rng(8), jnp.zeros((1, 300, 300, 3)))
    for i in range(6):
        variables["params"][f"conf_head{i}"]["kernel"] = variables["params"][f"conf_head{i}"]["kernel"] * 6
    save_variables_npz(variables, str(tmp_path / "ssd.npz"))
    square = _png(tmp_path / "square.png", 300, 300, 1)
    _png(tmp_path / "wide.png", 200, 260, 2)
    flags = ["--model", "ssd", "--device", "cpu", "--checkpoint_dir", str(tmp_path), "--weights", "ssd.npz",
             "--score_thresh", "0.4"]
    records = cli.main(flags + ["--images", str(tmp_path / "square.png"), str(tmp_path / "wide.png"),
                                "--output", str(tmp_path / "dets.json"), "--draw", str(tmp_path / "drawn")])
    assert json.load(open(tmp_path / "dets.json")) == records
    assert sorted(p.name for p in (tmp_path / "drawn").iterdir()) == ["square_det.png", "wide_det.png"]

    outputs = jax_build_ssd(JaxSSDConfig()).apply(variables, jax_normalize(jnp.asarray(square[None])), train=False)
    dets = jax.tree.map(np.asarray, jax_ssd_predict(outputs, jax_flat_anchors(JaxSSDConfig()), score_thresh=0.4))
    keep = dets["valid"][0]
    _same_set(records[0], {k: dets[k][0][keep] for k in ("boxes", "scores", "labels")}, 1e-5)

    service = server.build_service(server.get_parser().parse_args(flags))
    _same_set(records[1], service.predict_image(np.asarray(Image.open(tmp_path / "wide.png"))), 1e-5)


def test_cli_destr(tmp_path):
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, dropout=0.0, use_flash_attention=True))
    variables = _random_variables(jax_model, np.random.default_rng(5), jnp.zeros((1, SIZE, SIZE, 3)))
    save_variables_npz(variables, str(tmp_path / "destr.npz"))
    images = [_png(tmp_path / f"{i}.png", h, w, 10 + i) for i, (h, w) in enumerate([(40, 64), (64, 48)])]
    files = [str(tmp_path / f"{i}.png") for i in range(2)]
    flags = ["--device", "cpu", "--checkpoint_dir", str(tmp_path), "--weights", "destr.npz"] + DESTR_FLAGS
    records = cli.main(flags + ["--images", *files, "--output", str(tmp_path / "dets.json")])
    jax_service = JaxService("destr", jax_model, variables, SIZE, 0.0, letterbox=True)
    for rec, image, f in zip(records, images, files):
        assert rec["file"] == f
        _close(rec, jax_service.predict_image(image), 2e-3, 1e-3)

    stretched = cli.main(flags + ["--no-letterbox", "--images", *files, "--output", str(tmp_path / "s.json")])
    service = server.build_service(server.get_parser().parse_args(flags + ["--no-letterbox"]))
    for rec, image in zip(stretched, images):
        _close(rec, service.predict_image(image), 1e-6, 1e-6)


def test_cli_needs_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--model", "ssd", "--checkpoint_dir", str(tmp_path), "--images", "none.png"])
