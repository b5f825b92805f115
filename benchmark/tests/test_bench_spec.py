"""BENCHMARK.json against the benchmark's contract: names and units, the
metrics each cell reports, the files the harness finds by name, and the
limits on bounds, sizes and the length of a full check."""

import json
import re

import pytest

from benchmark import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (cells.ROOT / p).is_dir()
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_just_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == want, e["name"]


def test_metrics_units_sources_and_bounds():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        target = E2E[m["moves"]]
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        assert "workloads" not in target or set(m["workloads"]) <= set(target["workloads"])


def test_every_layer_is_in_perf_md():
    text = (cells.ROOT / "PERF.md").read_text()
    section = text[text.index("## 3. Layers"):text.index("## 4. Cells")]
    rows = {line.split("|")[1].strip() for line in section.splitlines() if line.startswith("| ")}
    assert {m["layer"] for m in BENCH["per_layer"]} <= rows


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_reports_enough(workload):
    cell = cells.load_cell(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("workload", CELLS)
def test_the_files_of_a_cell_are_found_by_name(workload):
    cell = cells.load_cell(workload)
    assert cell.job_module().Job and cell.reference().forward
    assert (cells.HERE / "limits" / f"{workload}.json").exists() and cell.limits
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    w = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configs_name_their_cuts():
    for c in BENCH["configs"]:
        body = json.loads((cells.ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and c["name"] == body["name"]
        assert sorted(c["reduced"]) == sorted(body["reduced"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_a_full_check_of_24_cells_fits():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
