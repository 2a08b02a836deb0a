"""BENCHMARK.json against the benchmark's contract, and every name in it
found in portbench/: cells, configurations, drivers, per-layer readers.

    python -m pytest portbench/tests -q
"""
import json
import os
import re

import pytest

from portbench import run as harness

ROOT = harness.ROOT
PB = harness.PB
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    assert len(json.dumps(manifest).encode()) <= 64 * 1024


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in cmd:
        assert not w.startswith("/") and ".." not in w


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [w["config"] for w in manifest["workloads"]]
    names += [w["traffic"] for w in manifest["workloads"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in SOURCES for m in metrics)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in manifest[key]}) == len(manifest[key])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_their_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])


def test_every_cell_reports_what_it_must(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        ends = harness.cell_metrics(manifest, "end_to_end", cell)
        layers = harness.cell_metrics(manifest, "per_layer", cell)
        assert len(ends) >= 2 and layers, cell
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_name_resolves(manifest):
    for c in manifest["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(
            os.path.dirname(os.path.join(ROOT, c["file"])),
            cfg["config"]["map"]["json_path"]))
    for w in manifest["workloads"]:
        spec = harness.load_json(os.path.join(PB, "workloads",
                                              f"{w['name']}.json"))
        assert os.path.isfile(os.path.join(PB, "drivers",
                                           f"{spec['driver']}.py"))
        assert set(spec["limits"]) >= {"car_gap_m", "frame_px_mismatch"}
    for m in manifest["per_layer"]:
        mod = harness.load_module(
            os.path.join(PB, "layer_metrics", f"{m['name']}.py"),
            "reader_" + m["name"].replace(".", "_"))
        assert callable(mod.read)


def test_four_chip_cells_are_few(manifest):
    n4 = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert n4 <= max(1, len(manifest["workloads"]) // 4)
