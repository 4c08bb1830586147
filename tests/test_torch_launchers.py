"""The port's launchers, ``scripts/*_torch.sh``, against the JAX package's.

Each launcher runs with ``PATH`` led by a directory whose ``python`` is a
stub: it writes the argument list bash built (``"$@"`` included) and its
working directory as JSON, and exits. The port's launcher must start the
port's training module, from the repository's root, with a config equal to
the one the JAX launcher's arguments give through JAX's parser, field for
field; only ``--device`` differs ("tpu" in JAX, None, the GPU, in the port),
and it is no field of either config. ``--help`` runs with the real
interpreter.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from object_detection_destr_tpu.train import arg_parser as jax_args
from object_detection_destr_tpu_torch.train import arg_parser as port_args
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TIMEOUT_S = 60

# (JAX launcher, port launcher, model, flags a run appends)
PAIRS = [
    ("train_destr.sh", "train_destr_torch.sh", "destr",
     ["--epochs", "2", "--image_size", "320", "--top_k", "100", "--letterbox"]),
    ("train_ssd.sh", "train_ssd_torch.sh", "ssd",
     ["--epochs", "2", "--hard_neg_mining", "paper", "--batch_size", "8"]),
    ("train_prod_synth.sh", "train_prod_synth_torch.sh", "destr",
     ["--epoch_scan", "--epochs", "40", "--save_as", "port_prod_r2", "--resume", "--resume_from", "port_prod_r2_last"]),
    ("train_prod_ssd.sh", "train_prod_ssd_torch.sh", "ssd",
     ["--epochs", "40", "--resume", "--resume_from", "ssd_prod_last"]),
]
MODULES = {"destr": "train.train", "ssd": "train.train_ssd"}

STUB = """#!{python}
import json, os, sys
with open(os.environ["LAUNCHER_ARGV"], "w") as f:
    json.dump({{"argv": sys.argv[1:], "cwd": os.getcwd()}}, f)
"""


@pytest.fixture()
def stub_path(tmp_path):
    """(PATH with the stub ``python`` first, the file it writes)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    return f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}", tmp_path / "argv.json"


def launch(script: str, extra: list[str], stub_path) -> dict:
    """Run ``script`` with ``extra`` appended under the stub; returns what
    the stub recorded."""
    path, out = stub_path
    env = {**os.environ, "PATH": path, "LAUNCHER_ARGV": str(out)}
    done = subprocess.run(["bash", script, *extra], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stderr
    return json.loads(out.read_text())


def parsed(parser_module, model: str, argv: list[str]):
    """(the namespace, the config as a dict) of ``argv`` through a package's
    ``get_parser`` / ``config_from_args``."""
    args = parser_module.get_parser(model).parse_args(argv)
    return args, dataclasses.asdict(parser_module.config_from_args(args, model))


def assert_same_config(jax_argv: list[str], port_argv: list[str], model: str) -> None:
    """The two packages' parsers give equal configs, field for field, and
    differ in ``--device`` only."""
    j_args, j_cfg = parsed(jax_args, model, jax_argv[2:])
    p_args, p_cfg = parsed(port_args, model, port_argv[2:])
    assert (j_args.device, p_args.device) == ("tpu", None)
    for section in j_cfg:
        for field, value in j_cfg[section].items():
            assert p_cfg[section][field] == value, f"{section}.{field}: port {p_cfg[section][field]!r}, JAX {value!r}"
    assert p_cfg == j_cfg


@pytest.mark.parametrize("jax_script,port_script,model,extra", PAIRS, ids=[p[1] for p in PAIRS])
def test_launcher_config_matches_jax(jax_script, port_script, model, extra, stub_path):
    """The port's launcher starts the port's module from the repository's
    root with ``extra`` last, and its config is the JAX launcher's."""
    jax_run = launch(os.path.join(SCRIPTS, jax_script), extra, stub_path)
    port_run = launch(os.path.join(SCRIPTS, port_script), extra, stub_path)
    module = MODULES[model]
    assert jax_run["argv"][:2] == ["-m", f"object_detection_destr_tpu.{module}"]
    assert port_run["argv"][:2] == ["-m", f"object_detection_destr_tpu_torch.{module}"]
    assert port_run["cwd"] == jax_run["cwd"] == ROOT
    assert port_run["argv"][len(port_run["argv"]) - len(extra):] == extra  # "$@" last
    assert_same_config(jax_run["argv"], port_run["argv"], model)
    assert port_run["argv"][2:] == jax_run["argv"][2:]  # the flags themselves, letter for letter


@pytest.mark.parametrize("jax_script,port_script,model,drop,field", [
    ("train_prod_synth.sh", "train_prod_synth_torch.sh", "destr", "--ema_decay 0.999 ", "train.ema_decay"),
    ("train_prod_ssd.sh", "train_prod_ssd_torch.sh", "ssd", "--hard_neg_mining paper", "ssd.hard_neg_mining"),
], ids=["prod_synth_without_ema", "prod_ssd_without_mining"])
def test_comparison_catches_a_dropped_flag(jax_script, port_script, model, drop, field, stub_path, tmp_path):
    """A copy of a recipe launcher with one flag taken out fails the config
    comparison on that flag's field."""
    copy_dir = tmp_path / "repo" / "scripts"
    copy_dir.mkdir(parents=True)
    text = open(os.path.join(SCRIPTS, port_script)).read()
    assert drop in text
    (copy_dir / port_script).write_text(text.replace(drop, ""))
    jax_argv = launch(os.path.join(SCRIPTS, jax_script), [], stub_path)["argv"]
    port_argv = launch(str(copy_dir / port_script), [], stub_path)["argv"]
    with pytest.raises(AssertionError, match=field):
        assert_same_config(jax_argv, port_argv, model)


@pytest.mark.parametrize("script,model", [("train_destr_torch.sh", "destr"), ("train_ssd_torch.sh", "ssd")])
def test_launcher_help(script, model, tmp_path):
    """``--help`` prints the header and the port's parser's usage, from any
    working directory, and exits 0."""
    done = subprocess.run(["bash", os.path.join(SCRIPTS, script), "--help"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stderr
    assert "PyTorch port" in done.stdout
    assert f"object_detection_destr_tpu_torch {model} training" in done.stdout
    assert "--device" in done.stdout and "--epoch_scan" in done.stdout
