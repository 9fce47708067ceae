"""BENCHMARK.json and the files the harness finds by name."""

import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT

from cmr_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_by_name():
    bench = spec.load_benchmark()
    for cell in bench["workloads"]:
        cfg = spec.config(cell["config"])
        assert os.path.exists(cfg["scene"])
        traffic = spec.traffic(cell["traffic"])
        assert {"width", "height", "samples", "camera_azimuth_deg", "check_pixels"} <= set(traffic)
        assert set(spec.limits(cell["name"])) == {"flip_pct", "median_err"}
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(bench, kind, cell["name"]):
                assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert spec.config(c["name"])["source"] == c["source"]
        assert set(c["reduced"]) == set(spec.config(c["name"])["reduced"])


def test_benchmark_json_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["cmr_bench"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            e2e_of_w = {x["name"] for x in spec.metrics_of(bench, "end_to_end", w)}
            assert m["moves"] in e2e_of_w
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs)), "a pair of configuration and traffic is given twice"
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and 1 <= len(c["why"]) <= 200
    for w in cells.values():
        assert len(w["why"]) <= 200 and w["config"] in {c["name"] for c in bench["configs"]}
        assert spec.metrics_of(bench, "per_layer", w["name"])


def test_run_without_a_card_exits_4_and_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "-m", "cmr_bench.run", "--workload", "showcase-preview",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 4 and out.stdout == "", (out.returncode, out.stdout, out.stderr)


def test_added_files_are_found_without_edits(tmp_path):
    """A new configuration, traffic mix, cell limits and metric reader, and
    the entries that name them, are all the harness needs."""
    shutil.copytree(os.path.join(ROOT, "cmr_bench"), tmp_path / "cmr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "cmr_bench"
    cfg = json.load(open(b / "configs" / "showcase-default.json"))
    cfg["options"]["max_depth"] = 8
    json.dump(cfg, open(b / "configs" / "showcase-shallow.json", "w"))
    traffic = dict(json.load(open(b / "traffic" / "preview-128.json")), width=64, height=64)
    json.dump(traffic, open(b / "traffic" / "preview-64.json", "w"))
    shutil.copy(b / "limits" / "showcase-preview.json", b / "limits" / "shallow-preview.json")
    (b / "metrics" / "renders_in_window.py").write_text(
        "def read(rec):\n    return len(rec.latencies_s)\n")
    bench["configs"].append({"name": "showcase-shallow", "source": cfg["source"],
                             "file": "cmr_bench/configs/showcase-shallow.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "shallow-preview", "config": "showcase-shallow",
                               "traffic": "preview-64", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "renders_in_window", "unit": "renders", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "previews_per_s", "workloads": ["shallow-preview"]})
    bench["end_to_end"][1]["workloads"].append("shallow-preview")
    bench["end_to_end"][2]["workloads"].append("shallow-preview")
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    script = (
        "from cmr_bench import spec; from cmr_bench.record import Record\n"
        "b = spec.load_benchmark(); c = spec.cell(b, 'shallow-preview')\n"
        "assert spec.config(c['config'])['options']['max_depth'] == 8\n"
        "assert spec.traffic(c['traffic'])['width'] == 64\n"
        "assert spec.limits('shallow-preview')\n"
        "ms = [m['name'] for m in spec.metrics_of(b, 'per_layer', 'shallow-preview')]\n"
        "assert 'renders_in_window' in ms, ms\n"
        "r = Record(paths_per_render=1, setup_s=1.0, window_s=1.0, latencies_s=[0.5, 0.5])\n"
        "assert spec.reader('renders_in_window')(r) == 2\n"
        "print('found')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "found" in out.stdout
