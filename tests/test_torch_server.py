"""The port's DetectionService against the JAX package's, at a tiny size.

Both services serve one tiny DESTR (64px canvas, hidden 32, 4 heads, 2+2
blocks, top_k 4, 3 classes) with the same weights: the JAX one from its
variables, the port's through ``build_service`` from the ``.npz`` file. The
uint8 image's long side equals the canvas, so no resize happens and both
see the same pixels. Tolerances: boxes 2e-3 and scores 1e-3 absolute (the
decoder-path tolerances of tests/test_torch_model.py on normalized values);
counts and labels equal.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.data.loader import (  # noqa: E402
    _letterbox_canvas as jax_letterbox_canvas,
    _resize_canvas as jax_resize_canvas,
)
from object_detection_destr_tpu.infer.server import DetectionService as JaxService  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu_torch.data.loader import _letterbox_canvas, _resize_canvas  # noqa: E402
from object_detection_destr_tpu_torch.infer.server import (  # noqa: E402
    _make_handler,
    build_service,
    get_parser,
)
from object_detection_destr_tpu_torch.models.convert import save_variables_npz  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

SIZE = 64
TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2,
            num_decoder_blocks=2, top_k=4, num_cls=3)
FLAGS = ["--image_size", str(SIZE), "--hidden_dim", "32", "--num_heads", "4",
         "--ffn_dim", "64", "--num_encoder_blocks", "2", "--num_decoder_blocks", "2",
         "--top_k", "4", "--num_cls", "3", "--score_thresh", "0.0"]


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    rng = np.random.default_rng(5)
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, dropout=0.0, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    jax_service = JaxService("destr", jax_model, variables, SIZE, 0.0, letterbox=True)
    ckpt = tmp_path_factory.mktemp("ckpt")
    save_variables_npz(variables, str(ckpt / "model_weights.npz"))
    args = get_parser().parse_args(
        ["--checkpoint_dir", str(ckpt), "--weights", "model_weights", "--device", "cpu"] + FLAGS
    )
    return jax_service, build_service(args), ckpt


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw", [(40, 64), (64, 48)])
def test_service_matches_jax(services, hw):
    jax_service, service, _ = services
    image = _image(*hw, seed=hw[0])
    ref = jax_service.predict_image(image)
    ours = service.predict_image(image)
    assert len(ours["boxes"]) == len(ref["boxes"]) == TINY["top_k"]
    assert ours["labels"] == ref["labels"]
    np.testing.assert_allclose(ours["scores"], ref["scores"], atol=1e-3)
    np.testing.assert_allclose(ours["boxes"], ref["boxes"], atol=2e-3)


def test_http_round_trip(services):
    from PIL import Image

    _, service, _ = services
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        image = _image(48, 64, seed=9)
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=buf.getvalue(), method="POST"
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            det = json.load(r)
        want = service.predict_image(image)
        assert det["labels"] == want["labels"]
        np.testing.assert_allclose(det["boxes"], want["boxes"], atol=1e-6)
        np.testing.assert_allclose(det["scores"], want["scores"], atol=1e-6)
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=b"not an image", method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_build_service_device_and_model_rules(services):
    _, _, ckpt = services
    base = ["--checkpoint_dir", str(ckpt), "--weights", "model_weights.npz"] + FLAGS
    if not torch.cuda.is_available():
        # no --device on a host without CUDA: raise, never serve on the CPU quietly
        with pytest.raises(RuntimeError, match="CUDA"):
            build_service(get_parser().parse_args(base))
    # --model ssd builds an SSD, which takes no DESTR weights
    with pytest.raises(KeyError, match="backbone.conv0.weight"):
        build_service(get_parser().parse_args(base + ["--model", "ssd", "--device", "cpu"]))


@pytest.mark.parametrize("hw", [(100, 75), (75, 100), (30, 20), (64, 64)])
def test_canvas_resize_matches_cv2(hw):
    image = _image(*hw, seed=sum(hw))
    ours, fh, fw = _letterbox_canvas(image, SIZE)
    ref, rfh, rfw = jax_letterbox_canvas(image, SIZE)  # cv2 where installed
    assert (fh, fw) == (rfh, rfw)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    stretched = _resize_canvas(image, SIZE).astype(int)
    assert np.abs(stretched - jax_resize_canvas(image, SIZE).astype(int)).max() <= 1
