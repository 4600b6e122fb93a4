"""Tests of the benchmark (``hintbench/``). CPU tests run the harness at a
tiny width on the program's plain path; tests marked ``card`` need a CUDA
card and skip without one:

    python -m pytest hintbench/tests -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (the port's kernels have no CPU mode); skips without one"
    )


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the program's kernels, which have no CPU mode")
    return torch.device("cuda", 0)


TINY = {"c_internal": [64, 32, 16], "hidden": 64, "batch_size": 500, "n_train": 5000, "max_batches_per_epoch": 10}


#: cells whose files the benchmark keeps though BENCHMARK.json does not list
#: them (PERF.md, Open questions): name -> (configuration, traffic, the
#: listed cell whose metrics it would report)
KEPT = {"hint4-serve": ("plus_shape.unconditional_hint_4_full", "serve_mix", "rcinn4-posterior"),
        "hint4-train": ("plus_shape.unconditional_hint_4_full", "train", "rcinn4-train")}

#: the configurations that only kept cells use, as BENCHMARK.json would list them
KEPT_CONFIGS = [
    {"name": "plus_shape.unconditional_hint_4_full",
     "source": "https://github.com/vislearn/HINT (configs/plus_shape/unconditional_hint_4_full.py), arXiv:1905.10687",
     "file": "hintbench/configs/plus_shape.unconditional_hint_4_full.json", "reduced": [],
     "why": "the flagship HINT flow: 4 full-depth HAC blocks on d=100 with fixed Householder perms, batch 10,000"},
]


def cell(workload: str):
    """A cell of BENCHMARK.json, or a kept one as BENCHMARK.json would list
    it (its configuration added where no listed cell uses it, its metrics
    those of the listed cell of its kind)."""
    import json

    from hintbench.lib.spec import ROOT, Cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if workload in KEPT and workload not in {w["name"] for w in bench["workloads"]}:
        config, traffic, like = KEPT[workload]
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].extend(c for c in KEPT_CONFIGS if c["name"] == config)
        bench["workloads"].append({"name": workload, "config": config, "traffic": traffic, "chips": 1, "why": "kept"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"] = m["workloads"] + [workload]
    return Cell(workload, bench)


def tiny_cell(workload: str):
    """The cell at a tiny width, batch and traffic: what the CPU can run."""
    c = cell(workload)
    c.config.update(TINY)
    if c.traffic["kind"] == "serve":
        spec = {"log_grid": [10, 300, 4]} if "log_grid" in c.traffic["sizes"] else {"fixed": [100, 4]}
        c.traffic.update(clients=2, sizes=spec, check_per_client=3)
    return c
