"""BENCHMARK.json against the contract's shape, and discovery by name: a
cell, a configuration, a traffic mix and a metric added as files in a copy
of the benchmark are found without an edit to any file that is there."""

import json
import os
import re
import shutil

import pytest

from port_bench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def test_benchmark_has_the_contract_shape():
    bench = registry.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"] and bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(registry.ROOT, c["file"]))
        assert not any(WIDTH.search(k) for k in c["reduced"])
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells) and len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:  # every cell reports set-up, another end-to-end metric and a per-layer one
        assert len(registry.metrics_for(cell, False)) >= 2 and registry.metrics_for(cell, True)


def test_every_metric_has_a_reader_that_agrees():
    bench = registry.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = registry.load_reader(m["name"])
        assert reader.UNIT == m["unit"]
        if "layer" in m:
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        assert reader.read({}) is None  # a reader that finds nothing returns nothing


def test_every_cell_loads_its_files():
    for w in registry.load_benchmark()["workloads"]:
        cell = registry.load_cell(w["name"])
        assert os.path.exists(os.path.join(registry.BENCH_DIR, "generators", f"{cell.generator}.py"))
        assert set(cell.params["limits"]) and cell.config["name"] == w["config"]


def test_a_cell_config_mix_and_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH_DIR, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.load_benchmark()
    config = json.load(open(os.path.join(registry.ROOT, bench["configs"][0]["file"])))
    config["name"] = "destr-r50-coco-640"
    config["train"]["image_size"] = 640
    (root / "port_bench/configs/destr-r50-coco-640.json").write_text(json.dumps(config))
    mix = json.load(open(root / "port_bench/traffic/train-device-cache.json"))
    (root / "port_bench/traffic/train-device-cache-long.json").write_text(json.dumps({**mix, "chunk_steps": 64}))
    (root / "port_bench/workloads/train-coco-640.json").write_text(json.dumps({"images": 256, "limits": {"loss_gap": 1}}))
    (root / "port_bench/metrics/loss_ms.train.py").write_text(
        'LAYER = "criterion"\nUNIT = "ms"\nMOVES = "train_images_per_s"\n\n\ndef read(run):\n    return run.get("loss_ms")\n')
    bench["configs"].append({"name": "destr-r50-coco-640", "source": "DESTR, CVPR 2022",
                             "file": "port_bench/configs/destr-r50-coco-640.json", "reduced": ["data"], "why": "x"})
    bench["workloads"].append({"name": "train-coco-640", "config": "destr-r50-coco-640",
                               "traffic": "train-device-cache-long", "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "train_images_per_s")["workloads"].append("train-coco-640")
    bench["per_layer"].append({"name": "loss_ms.train", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "criterion", "moves": "train_images_per_s", "workloads": ["train-coco-640"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.load_cell("train-coco-640", str(root))
    assert cell.config["train"]["image_size"] == 640 and cell.params["chunk_steps"] == 64
    assert cell.params["images"] == 256 and cell.generator == "train_epochs"
    names = [m["name"] for m in registry.metrics_for("train-coco-640", True, str(root))]
    assert "loss_ms.train" in names and "mfu.train" not in names
    assert registry.load_reader("loss_ms.train", str(root)).read({"loss_ms": 3.5}) == 3.5
    assert [m["name"] for m in registry.metrics_for("train-coco-640", False, str(root))] == [
        "train_images_per_s", "setup_s"]
    with pytest.raises(KeyError):
        registry.load_cell("no-such-cell", str(root))
