"""BENCHMARK.json against the contract the benchmark is held to: every cell
and metric resolves to its files, names and units use the allowed
characters, each per-layer metric's ``moves`` is reported by its cells."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"] and not any(
        w.startswith("/") or ".." in w for w in BENCH["command"])
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            extra = set(entry) - KEYS[key] - ({"workloads"} if key in ("end_to_end", "per_layer")
                                               else set())
            assert set(entry) >= KEYS[key] and not extra, (key, entry["name"])


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    for e in BENCH[key]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e and key != "end_to_end" and not (key == "per_layer" and text == "source"):
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_end_to_end_bounds_and_sources():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_resolves_to_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        entry = configs[cell["config"]]
        assert (ROOT / entry["file"]).is_file() and entry["file"].startswith("portbench/")
        traffic = harness.traffic_of(ROOT, cell["traffic"])
        assert (ROOT / "portbench" / "runners" / f"{traffic['runner']}.py").is_file()
        assert hasattr(harness.runner_of(ROOT, traffic["runner"]), "Runner")
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == set(configs)
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader_of(ROOT, metric).read)


def test_moves_are_reported_by_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    layers: dict[str, str] = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        layers.setdefault(m["layer"], m["layer"])
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_four_chip_cells_and_budget():
    n = len(BENCH["workloads"])
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, n // 4)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_config_files_hold_the_run_configuration():
    for entry in BENCH["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"] == []
        assert set(cfg["precision"]) >= {"decoder", "chain_weights", "embedder", "encoder"}
