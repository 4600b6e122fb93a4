"""What ``BENCHMARK.json`` names, found by name: the cell, its
configuration (``configs/<name>.json`` and ``configs/<name>.py``), its
traffic mix (``traffic/<mix>.json``), its limits
(``limits/<workload>.json``) and the reader of each of its metrics
(``metrics/<metric>.py``, ``read(ctx)``, None where it finds nothing to
read)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # hintbench/
ROOT = HERE.parent  # the checkout


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str, cell_end_to_end=None) -> bool:
    """Whether a cell reports a metric: the cells listed under its
    ``workloads``; without the key, every cell (end-to-end) or every cell
    that reports the end-to-end metric it ``moves`` (per-layer)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return cell_end_to_end is None or metric["moves"] in cell_end_to_end


class Cell:
    def __init__(self, workload: str, bench: dict = None):
        self.bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = read_json(ROOT / self.config_entry["file"])
        self.config_module = load_module(Path(ROOT / self.config_entry["file"]).with_suffix(".py"),
                                         "hintbench_config_" + self.workload["config"].replace(".", "_"))
        self.traffic = read_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = read_json(HERE / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in self.bench["end_to_end"] if reports(m, workload)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"] if reports(m, workload, names)]

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py", "hintbench_metric_" + metric.replace(".", "_"))
