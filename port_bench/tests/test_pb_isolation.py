"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names; the reference loads nothing of the port either."""

import json
import os
import subprocess
import sys

from port_bench.harness import isolation

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = """
import json, sys, tempfile
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_levels(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, body=body)], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_are_compared():
    names = ["object_detection_destr_tpu_torch.models", "jaxtyping", "flax.linen", "object_detection_destr_tpu"]
    assert isolation.forbidden_modules(names) == {"flax.linen", "object_detection_destr_tpu"}
    assert isolation.forbidden_modules(names, also=[isolation.PORT]) == {
        "flax.linen", "object_detection_destr_tpu", "object_detection_destr_tpu_torch.models"}


def test_the_reference_loads_neither_jax_nor_the_port():
    body = "import port_bench.reference.steps, port_bench.reference.flash_plain"
    found = _top_levels(body)
    assert not found & (isolation.FORBIDDEN | {isolation.PORT}), found


def test_a_run_loads_no_jax():
    """A whole tiny run of each generator, set-up, window and reference, on the CPU."""
    body = ("import torch; torch.set_num_threads(2)\n"
            "from port_bench.tests.tiny import run_tiny\n"
            "from port_bench.harness.cli import main\n"
            "run_tiny('train-coco-800', tempfile.mkdtemp())")
    found = _top_levels(body)
    assert isolation.PORT in found  # the program ran
    assert not found & isolation.FORBIDDEN, found
