"""The port, chip_smoke.py and the port's tools (tools/*_torch.py and
tools/trace_window_check.py) import no JAX, no flax, no orbax and nothing of
the JAX package. Checked in a fresh interpreter, because this test process
has JAX loaded already (tests/conftest.py)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import object_detection_destr_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
for tool in ("profile_step_torch", "trace_window_check", "val_noise_torch", "postmortem_divergence_torch",
             "probe_flash_torch", "roofline_conv_torch", "bench_loader_torch"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
forbidden = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "object_detection_destr_tpu"))
print(json.dumps({"modules": names, "forbidden": forbidden}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == []
    # every module of the slices was imported
    for name in ("config", "ops.cuda.flash_attention", "ops.cuda.auction", "ops.assignment",
                 "models.destr.model", "models.convert", "infer.server", "data.transforms",
                 "data.datasets", "data.loader", "losses.matcher", "losses.criterion",
                 "train.optim", "train.state", "train.steps", "train.driver", "train.train",
                 "train.checkpoint", "losses.metrics", "infer.evaluate", "models.ssd.model", "ops.nms",
                 "infer.predict", "infer.cli", "train.train_ssd", "runtime.native", "train.logging_utils",
                 "models.import_weights", "parallel", "parallel.mesh", "ops.cuda.greedy_match"):
        assert f"object_detection_destr_tpu_torch.{name}" in result["modules"], name


def test_native_sources_are_the_ports_own():
    """The native pool builds from the port's copies of its C++ sources into
    the port's build directory, never from a file of the JAX package."""
    from object_detection_destr_tpu_torch.runtime import native

    port = os.path.join(REPO, "object_detection_destr_tpu_torch") + os.sep
    for name, (sources, _) in native.SOURCES.items():
        for src in sources:
            assert os.path.realpath(src).startswith(port) and os.path.exists(src), src
        assert os.path.realpath(native.library_path(name)).startswith(port + "_build" + os.sep)
