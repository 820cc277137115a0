"""The harness finds every cell, configuration, mix and per-layer metric by
name from files alone, and BENCHMARK.json keeps to the shape a later PR's
entries must keep to."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    f = harness.find_cell(ROOT, cell)
    entry = f["cell"]
    assert f["spec"]["name"] == entry["config"]
    assert f["mix"]["mode"] in ("detect", "train")
    harness.mode(f["mix"])  # the mix's driver imports
    assert f["limits"], "a cell compares at least one number"
    e2e = {m["name"] for m in f["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert f["per_layer"]
    for m in f["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_every_reader_and_file_named_in_benchmark_exists():
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "workloads" / f"{w['name']}.json").exists()


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])


def test_adding_a_cell_is_adding_files(tmp_path):
    """A new cell, its mix and a new per-layer metric are new files and new
    entries: the harness finds them with no edit to a file already there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "portbench"
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "r50_kitti.detect_b4", "config": "r50_kitti",
                               "traffic": "detect_b4", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "calls.detect", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "entry, host",
                               "moves": "detect_img_per_s", "workloads": ["r50_kitti.detect_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((here / "traffic" / "detect_closed.json").read_text())
    (here / "traffic" / "detect_b4.json").write_text(json.dumps(dict(mix, batch=4)))
    own = json.loads((here / "workloads" / "r50_kitti.detect_b16.json").read_text())
    (here / "workloads" / "r50_kitti.detect_b4.json").write_text(
        json.dumps(dict(own, traffic="detect_b4")))
    (here / "metrics" / "calls.detect.py").write_text(
        "COMBINE = 'max'\n\n\ndef read(t):\n    return len(t['enqueue_s'])\n")
    f = harness.find_cell(tmp_path, "r50_kitti.detect_b4")
    assert f["mix"]["batch"] == 4 and f["spec"]["network"] == "resnet50"
    assert [m["name"] for m in f["per_layer"]][-1] == "calls.detect"
    assert harness.reader("calls.detect", f["root"]).read({"enqueue_s": [1, 2]}) == 2
