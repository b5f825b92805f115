"""The cell a run measures, found by name in ``BENCHMARK.json``.

A cell is one entry of ``workloads``: a configuration (``configs/<name>.json``,
the file that ``BENCHMARK.json`` names) under a traffic mix
(``traffic/<traffic>.json``).  The traffic names its job
(``jobs/<job>.py``), the configuration its plain reference
(``reference/<reference>.py``), each per-layer metric its reader
(``metrics/<metric>.py``), and the cell its limits
(``limits/<workload>.json``).  Nothing here imports torch or the program.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The sizes one request or training batch has."""

    batch: int
    latent_frames: int
    latent_height: int
    latent_width: int
    text_tokens: int
    video_tokens: int


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple
    limits: dict

    @property
    def job(self) -> str:
        return self.traffic["job"]

    @property
    def model(self) -> dict:
        """The model as it is run in this cell's job: the configuration's
        ``run`` block with the job's depth."""
        m = dict(self.config["run"])
        if isinstance(m["depth"], dict):
            m["depth"] = m["depth"][self.job]
        return m

    @property
    def geometry(self) -> Geometry:
        m, t = self.model, self.traffic
        frames = (t["frames"] - 1) // m["vae_temporal"] + 1
        h, w = t["height"] // m["vae_spatial"], t["width"] // m["vae_spatial"]
        video = (frames // m["patch_t"]) * (h // m["patch"]) * (w // m["patch"])
        return Geometry(t["batch"], frames, h, w, m["text_len"], video)

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(f"benchmark.reference.{self.model['reference']}")

    def job_module(self):
        return importlib.import_module(f"benchmark.jobs.{self.job}")


def _metrics_of(entries: list, cell: str) -> tuple:
    return tuple(e for e in entries if "workloads" not in e or cell in e["workloads"])


def load_cell(workload: str) -> Cell:
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}
    return Cell(workload, w["chips"], config, traffic, _metrics_of(bench["end_to_end"], workload),
                _metrics_of(bench["per_layer"], workload), limits)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``: names hold dots, so the file is
    loaded by its path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
