"""BENCHMARK.json and the files it names: every configuration, traffic mix,
generator, limits file and per-layer reader is found by name and is valid."""

import math
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per_token")

BENCH = core.spec()


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_twenty_four_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        assert 1 <= len(BENCH[group]) <= {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}[group]
        for entry in BENCH[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert one_line(entry[text]), entry
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def test_configurations_are_files_under_paths():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p.rstrip("/") + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = core.load_json(core.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(w in k for k in c["reduced"] for w in WIDTHS) and not any(
            k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    run = core.Run(cell, 1, 1, 0, "cpu")
    assert run.workload["chips"] in (1, 4)
    gen = core.generator(run.traffic["kind"])
    for fn in ("setup", "window", "release", "readings", "end_to_end", "unit_flops"):
        assert callable(getattr(gen, fn))
    assert run.limits and all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in run.limits.values())
    e2e = run.end_to_end_names()
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = run.per_layer_names()
    assert per_layer
    for name in per_layer:
        assert callable(core.reader(name).read)


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_name_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"], (m["name"], cell)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_under_paths_are_named_from_name_characters():
    for path in (core.HERE).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(core.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
