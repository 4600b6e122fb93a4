"""Every cell of BENCHMARK.json finds its files by name, and the file keeps
to the rules on names, keys and sizes that BENCHMARK.json keeps."""

import json
import re

import pytest

from hintbench.lib.spec import HERE, ROOT, Cell
from hintbench.tests.conftest import KEPT, KEPT_CONFIGS
from hintbench.tests.conftest import cell as kept_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", sorted(KEPT))
def test_kept_cells_files_load(workload):
    """A cell whose files are kept for a later PR still finds them."""
    c = kept_cell(workload)
    numbers = {"train": {"loss_gap", "grad_gap", "change_gap"}, "serve": {"sample_gap", "logprob_gap"}}
    assert c.traffic["kind"] == {"serve_mix": "serve", "train": "train"}[KEPT[workload][1]]
    assert set(c.limits) == numbers[c.traffic["kind"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hintbench"] and BENCH["command"] == ["python3", "hintbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS + sorted(KEPT))
def test_cell_files_load_by_name(workload):
    cell = Cell(workload) if workload in WORKLOADS else kept_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["kind"] in ("train", "serve")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names
    for m in cell.per_layer + cell.end_to_end:
        assert callable(cell.reader(m["name"]).read)
    flow = cell.config_module.reference(cell.config)
    assert flow.dim == cell.config["ndim_x"] and flow.cond_dim == cell.config["ndim_y"]
    numbers = {"train": {"loss_gap", "grad_gap", "change_gap"},
               "serve": {"sample_gap"} | ({"logprob_gap"} if "log_prob" in cell.traffic.get("endpoints", []) else set())}
    assert set(cell.limits) == numbers[cell.traffic["kind"]]


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["configs"] + KEPT_CONFIGS, ids=lambda e: e["name"])
def test_config_file_is_the_registry_entry(entry):
    """The configuration file holds what runs, and the program's registry
    agrees with it field for field."""
    from hintbench.lib import program

    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    program.config(cfg, strict=True)


def test_every_file_under_paths_is_named_from_name_characters():
    for p in HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
