"""BENCHMARK.json against the contract's names and limits, and the harness
finding a configuration, traffic mix and metric added as files."""

import json
import os
import re
import shutil

import pytest

from gpubench import harness

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_names_units_and_keys(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    named = bench["configs"] + bench["workloads"] + bench["end_to_end"] + \
        bench["per_layer"]
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("gpubench/") and 1 <= len(c["source"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for text in [w["why"] for w in bench["workloads"]] + bench["command"]:
        assert "\t" not in text and "\n" not in text


def test_every_entry_has_its_files(bench):
    for w in bench["workloads"]:
        cell, config, traffic, entries = harness.load_cell(ROOT, w["name"], 1)
        assert traffic["mode"] and config["data"]["reads"] > 0
        assert entries, w["name"]
        for m in entries + harness.cell_metrics(bench, w["name"], 0):
            assert callable(harness.reader(m["name"]))
        # every cell reports setup_s, one other end-to-end metric and a
        # per-layer one
        assert len(harness.cell_metrics(bench, w["name"], 0)) >= 2


def test_added_files_are_found_without_edits(bench, tmp_path):
    """A configuration, a traffic mix and a metric added as files, with their
    entries in BENCHMARK.json, are found by name."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "gpubench/configs/rna_toyset.json").read_text())
    cfg["data"]["reads"] = 123
    (root / "gpubench/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (root / "gpubench/traffic/dummy.mix.json").write_text(json.dumps(
        {"mode": "cluster", "pool": 2, "data": {"genes": 7}}))
    (root / "gpubench/metrics/dummy_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append(dict(b["configs"][0], name="dummy_cfg",
                             file="gpubench/configs/dummy_cfg.json"))
    b["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                           "traffic": "dummy.mix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "dummy_metric", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "Device", "moves": "setup_s",
                           "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell, config, traffic, entries = harness.load_cell(str(root), "dummy.cell",
                                                       1)
    assert config["data"]["reads"] == 123 and traffic["data"]["genes"] == 7
    assert [m["name"] for m in entries] == ["dummy_metric"]
    assert harness.reader("dummy_metric", str(root))({}) == 42.0
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "dummy.cell", 1)


DUMMY_MODE = '''
import os

OUTPUTS = ("echo.txt",)
CHECKS = {"echoes_wrong": ("sum", 0)}
TRACE_CHECKED = {}
SPANS = []


def make_inputs(slot, data, seed, k):
    path = os.path.join(slot, "x.txt")
    with open(path, "w") as fh:
        fh.write(f"{seed} {k}")
    return {"file": path}, data["reads"]


def argv(config, inputs, out, device):
    return ["echo", inputs["file"], out]


def output(out):
    with open(os.path.join(out, "echo.txt"), "rb") as fh:
        return {"echo.txt": fh.read()}


def reference(inputs, config, control=""):
    with open(inputs["file"], "rb") as fh:
        return {"echo.txt": fh.read()}


def compare(got, want):
    return {"echoes_wrong": int(got != want)}
'''

DRIVE = '''
import json, shutil, sys, time
from gpubench import harness

class Echo:
    cuda = False

    def __init__(self, inputs, jobs):
        pass

    def job(self, argv):
        shutil.copy(argv[1], argv[2] + "/echo.txt")
        return dict(wall_s=0.001, cpu_s=0.0, stages={}, launches={})

cell, config, traffic, entries = harness.load_cell(".", "dummy.cell", 0)
out = harness.execute(cell["name"], 1, config, traffic, entries, 5, 0.0, 0,
                      time.perf_counter(), device="cpu", root=".",
                      program=Echo)
print(json.dumps(out))
'''


def test_a_mode_added_as_a_file_runs_without_edits(bench, tmp_path):
    """A new mode (its inputs, arguments, output, reference and numbers
    compared), a mix naming it and a metric, added as files to a copy of
    the benchmark, drive a whole run of the harness."""
    import subprocess
    import sys
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "gpubench/modes/echo.py").write_text(DUMMY_MODE)
    (root / "gpubench/traffic/echo.mix.json").write_text(json.dumps(
        {"mode": "echo", "pool": 2, "data": {}}))
    (root / "gpubench/metrics/echo_work.py").write_text(
        "def read(run):\n    return float(run['work'])\n")
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "dummy.cell",
                           "config": b["configs"][0]["name"],
                           "traffic": "echo.mix", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "echo_work", "unit": "reads",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = subprocess.run([sys.executable, "-c", DRIVE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] == 2
    assert out["checks"] == {"echoes_wrong": {"value": 0, "limit": 0}}
    reads = json.loads((root / "gpubench/configs" / os.path.basename(
        b["configs"][0]["file"])).read_text())["data"]["reads"]
    assert out["metrics"]["echo_work"]["value"] == 2 * reads


DRIVE_TRACED = DRIVE.replace("""        return dict(wall_s=0.001, cpu_s=0.0, stages={}, launches={})
""", """        return dict(wall_s=0.001, cpu_s=0.0, stages={}, launches={})

    def traced_job(self, argv, mode):
        rec = self.job(argv)
        rec.update(window=(0.0, 1.0), device=[("k", 0.25, 0.5)], spans=[])
        return rec
""")


@pytest.mark.parametrize("source,traced", [("host_clock", 0),
                                           ("device_trace", 2)])
def test_a_device_trace_end_to_end_metric_traces_after_the_window(
        bench, tmp_path, source, traced):
    """An untraced run takes one traced job a pool set after the window only
    where an end-to-end metric of its cell comes from the device's trace;
    its line then still has no busy_s, window_s or breakdown."""
    import subprocess
    import sys
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "gpubench/modes/echo.py").write_text(DUMMY_MODE)
    (root / "gpubench/traffic/echo.mix.json").write_text(json.dumps(
        {"mode": "echo", "pool": 2, "data": {}}))
    (root / "gpubench/metrics/echo_traced.py").write_text(
        "def read(run):\n    return float(len(run['traced']))\n")
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "dummy.cell",
                           "config": b["configs"][0]["name"],
                           "traffic": "echo.mix", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "echo_traced", "unit": "jobs",
                            "better": "lower", "bound": 0.01,
                            "source": source, "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = subprocess.run([sys.executable, "-c", DRIVE_TRACED], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] == 2 + traced
    assert out["metrics"]["echo_traced"]["value"] == traced
    assert "busy_s" not in out["device"] and "breakdown" not in out
