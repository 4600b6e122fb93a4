"""The program's spans in a traced window (``lib/spans.py``) and the readers
of the metrics that read them (``spanned.SPAN_METRICS``), on made-up
profiles: operations put down to spans by correlation id, also from a
second thread; idle time divided by intersection; device-side annotations
counted nowhere; the accepted summary unchanged by program spans."""

import json
import re

import pytest

from hintbench.lib import spans as SP
from hintbench.lib import trace as TR
from hintbench.lib.spec import HERE, ROOT, load_module
from hintbench.spanned import SPAN_METRICS

MAIN, AUTOGRAD = 1, 2


class _Event:
    """What ``torch.profiler`` gives of one event, in microseconds."""

    def __init__(self, name, device, start, end, thread=0, corr=0, annotation=False):
        self._v = (name, device, start, end, thread, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return int(self._v[2] * 1e3)

    def end_ns(self):
        return int(self._v[3] * 1e3)

    def duration_ns(self):
        return self.end_ns() - self.start_ns()

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class _Prof:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def _host(name, start, end, thread=MAIN, corr=0):
    return _Event(name, False, start, end, thread, corr)


def _kernel(name, start, end, corr):
    return _Event(name, True, start, end, 0, corr)


def _step():
    """One training step in a window of 1,000 us: the forward launches one
    kernel and waits 20 us on a full command buffer; the backward runs on
    the autograd thread, which launches one kernel under a ``hac.pack`` and
    one with no span of its own open; the optimizer launches one. A
    synchronise after the step waits outside every span."""
    program = [_host("train.step", 100, 600), _host("train.forward", 110, 200),
               _host("train.backward", 210, 500), _host("train.optimizer", 510, 590),
               _host("hac.pack", 300, 320, AUTOGRAD)]
    rest = [
        _host(TR.WINDOW, 0, 1000), _Event(TR.WINDOW, True, 10, 990, annotation=True),
        _host("cudaLaunchKernel", 120, 125, MAIN, 5), _kernel("hac_block_loop_kernel", 130, 250, 5),
        _host("Command Buffer Full", 150, 170), _host("aten::mm", 140, 190),
        _host("cudaLaunchKernel", 305, 310, AUTOGRAD, 7), _kernel("gather_kernel", 330, 380, 7),
        _host("cudaLaunchKernel", 400, 404, AUTOGRAD, 8), _kernel("hac_block_bwd_data", 400, 450, 8),
        _host("cudaLaunchKernel", 520, 522, MAIN, 6), _kernel("multi_tensor_apply_kernel", 520, 560, 6),
        _host("cudaStreamSynchronize", 620, 700, MAIN, 9),
    ]
    return program, rest


def _attribute(events):
    evs = SP.events(_Prof(events))
    return SP.attribute(evs, 0.0, 1000.0)


def _close(row, **want):
    for k, v in want.items():
        assert row[k] == pytest.approx(v, abs=1e-12), (k, row[k], v)


def test_operations_go_to_the_span_that_launched_them_by_correlation_id():
    program, rest = _step()
    got = _attribute(program + rest)
    _close(got["train.forward"], n=1, ops=1, ops_s=120e-6, blocked_s=20e-6)
    _close(got["hac.pack"], n=1, ops=1, ops_s=50e-6)
    # the autograd thread's launch with no span of its own open, and its hac.pack, are the backward's
    _close(got["train.backward"], n=1, ops=2, ops_s=100e-6, blocked_s=0.0)
    _close(got["train.optimizer"], n=1, ops=1, ops_s=40e-6)
    _close(got["train.step"], n=1, ops=4, ops_s=260e-6, host_s=500e-6, blocked_s=20e-6)
    assert set(got) == {"train.step", "train.forward", "train.backward", "train.optimizer", "hac.pack"}


def test_idle_time_is_divided_among_the_innermost_spans_by_intersection():
    program, rest = _step()
    got = _attribute(program + rest)
    # busy 130-250, 330-380, 400-450, 520-560; the idle stretches 0-100 and 600-1000 lie under no span
    want = {"train.step": 30e-6, "train.forward": 20e-6, "train.backward": 130e-6, "hac.pack": 20e-6,
            "train.optimizer": 40e-6}
    for name, idle in want.items():
        _close(got[name], idle_s=idle)
    summary = TR.summarize(_Prof(program + rest))
    assert sum(r["idle_s"] for r in got.values()) <= summary["window_s"] - summary["busy_s"] + 1e-12


def test_device_side_annotations_are_no_operations():
    program, rest = _step()
    mirrors = [_Event("train.step", True, 130, 560, annotation=True),
               _Event("train.backward", True, 330, 450, annotation=True)]
    assert _attribute(program + rest + mirrors) == _attribute(program + rest)


def test_the_accepted_summary_is_unchanged_by_program_spans():
    """The program's spans are host-side ranges: every number of the
    accepted summary is the same with them as without; only the names of
    idle gaps that begin under one change."""
    program, rest = _step()
    with_spans, without = TR.summarize(_Prof(program + rest)), TR.summarize(_Prof(rest))
    for key in ("busy_s", "window_s", "device_ops"):
        assert with_spans[key] == without[key], key
    assert sum(s for _, s in with_spans["idle"]) == pytest.approx(sum(s for _, s in without["idle"]))
    assert "train.optimizer" in dict(with_spans["idle"]) and "train.optimizer" not in dict(without["idle"])


def test_a_span_over_the_windows_edge_counts_only_inside_it():
    got = SP.attribute(SP.events(_Prof([_host("serve.sample", -50, 50), _host("serve.d2h", 900, 1100)])),
                       0.0, 1000.0)
    _close(got["serve.sample"], n=0, host_s=50e-6, idle_s=50e-6)
    _close(got["serve.d2h"], n=1, host_s=100e-6, idle_s=100e-6)


def _ctx(spans, counters=None, window_s=1.0):
    return {"trace": {"spans": spans, "window_s": window_s, "busy_s": 0.5, "device_ops": []},
            "counters": counters if counters is not None else {}}


def _read(name, ctx):
    return load_module(HERE / "metrics" / f"{name}.py", "m_" + name).read(ctx)


def _row(**kw):
    return {**dict.fromkeys(SP.FIELDS, 0), **kw}


def test_training_readers_on_a_made_up_step():
    program, rest = _step()
    ctx = _ctx(_attribute(program + rest))
    assert _read("train_host_ms", ctx) == pytest.approx(0.48)
    assert _read("train_launches_per_step", ctx) == 4
    assert _read("train_opt_ms", ctx) == pytest.approx(0.04)
    assert _read("train_repack_ms", ctx) == pytest.approx(0.05)


def test_serving_readers_on_a_made_up_window():
    spans = {"serve.sample": _row(n=3, ops=90, idle_s=0.01), "serve.log_prob": _row(n=1, ops=30, idle_s=0.02),
             "serve.prepare": _row(n=4, idle_s=0.03), "serve.lock": _row(n=4), "serve.compute": _row(n=4, idle_s=0.04),
             "serve.h2d": _row(n=4, idle_s=0.05), "serve.d2h": _row(n=4, idle_s=0.15)}
    ctx = _ctx(spans, {"serve.rows": 4000, "serve.rows_computed": 4096, "serve.pages": 1}, window_s=2.0)
    assert _read("serve_idle_copy_pct", ctx) == pytest.approx(10.0)
    assert _read("serve_idle_service_pct", ctx) == pytest.approx(5.0)
    assert _read("serve_pad_pct", ctx) == 2.34375
    assert _read("serve_launches_per_request", ctx) == 30


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_span_readers_find_nothing_in_the_accepted_summary(metric):
    """Without spans and counters, as the accepted harness reads a run, and
    on a program that has none, each reader returns nothing and raises
    nothing."""
    ctx = {"trace": {"window_s": 1.0, "busy_s": 0.5, "device_ops": [("k", 0.5)], "idle": []},
           "run": {"steps": 10, "rows": 100, "attempted": 3, "failed": 0}}
    assert _read(metric, ctx) is None
    assert _read(metric, _ctx({}, {})) is None


def test_span_metric_entries_keep_the_benchmarks_rules():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for group in ("end_to_end", "per_layer") for m in bench[group]}
    cells = {w["name"] for w in bench["workloads"]}
    reports = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in SPAN_METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", m["name"]) and m["name"] not in names
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("program_span", "program_counter") and 1 <= len(m["layer"]) <= 200
        assert m["workloads"] and set(m["workloads"]) <= cells & reports[m["moves"]]
        assert callable(load_module(HERE / "metrics" / f"{m['name']}.py", "e").read)
    assert len({m["name"] for m in SPAN_METRICS}) == len(SPAN_METRICS) == 8


@pytest.mark.parametrize("workload", ["rcinn4-train", "rcinn4-posterior"])
def test_a_spanned_run_reads_the_span_metrics_of_its_cell_on_the_cpu(workload):
    """A whole traced run at a tiny width on the CPU, whose plain path packs
    nothing (no ``train_repack_ms``): the program's spans and counters reach
    the readers, and the harness is left as it was."""
    import torch

    from hintbench import spanned
    from hintbench.tests.conftest import tiny_cell

    summarize = TR.summarize
    out = spanned.run(tiny_cell(workload), 5, 0.3, torch.device("cpu"))
    assert TR.summarize is summarize
    mine = {m["name"] for m in SPAN_METRICS if workload in m["workloads"]} - {"train_repack_ms"}
    assert mine <= set(out["metrics"]), set(out["metrics"])
    c = out["counters"]
    if workload == "rcinn4-train":
        assert c["train.steps"] == out["attempted"] == out["spans"]["train.step"]["n"]
        assert "hac.pack" not in out["spans"] and "train_repack_ms" not in out["metrics"]
    else:
        assert c["serve.requests.sample"] == out["attempted"] == out["spans"]["serve.sample"]["n"]
        assert out["metrics"]["serve_pad_pct"]["value"] == 100.0 * (c["serve.rows_computed"] - c["serve.rows"]) / \
            c["serve.rows_computed"]
