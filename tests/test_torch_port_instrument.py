"""The port's spans and counters (``hint_tpu_torch.utils.instrument``) on
the CPU: a span costs no profiler call while none records, shows under
``torch.profiler`` nested as the trainer, the service and the HAC packing
open it and on the host's side alone, and the counters count exactly."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hint_tpu_torch.configs import get_config
from hint_tpu_torch.convert import params_to_numpy
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.serve import InferenceService
from hint_tpu_torch.utils import instrument

CPU = torch.device("cpu")
TRAIN = "lens_shape.unconditional_hint_1_full"  # d=20, one block
SERVE = "plus_shape.conditional_recursive_cinn_4"  # conditional: _y_for and the condition upload
BUCKETS = (64, 256)


def _trainer(cap=3):
    trainer = get_config(TRAIN).make_trainer(device="cpu")
    trainer.batch_size, trainer.max_batches_per_epoch = 16, cap
    return trainer, trainer.init_state(0), torch.randn((80, 20), generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def service():
    cfg = get_config(SERVE)
    model = cfg.build_model(device="cpu")
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    return InferenceService(cfg, params_to_numpy(model), buckets=BUCKETS, device="cpu")


def _events(prof):
    """(name, start_ns, end_ns, thread, is_user_annotation) of every host event."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _inside(events, child, parent) -> bool:
    """Every ``child`` event lies in a ``parent`` event of its thread."""
    kids = [e for e in events if e[0] == child]
    return bool(kids) and all(any(p[0] == parent and p[3] == c[3] and p[1] <= c[1] and c[2] <= p[2] for p in events)
                              for c in kids)


def test_span_calls_no_profiler_while_none_records(service, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened while no profiler records")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert instrument.span("train.step") is instrument.span("serve.sample")
    trainer, state, x = _trainer()
    terms = trainer.train_step(state, x[:16], None, torch.Generator().manual_seed(1), 1e-3)
    assert torch.isfinite(terms).all()
    out = service.sample(10, seed=0)
    assert out.shape == (10, 100) and np.isfinite(out).all()


def test_train_spans_nest_and_stay_on_the_host():
    trainer, state, x = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):  # a user-scope range, for contrast
            trainer.train_epoch(state, x, None, torch.Generator().manual_seed(1), 0)
    ev = _events(prof)
    names = [e[0] for e in ev]
    assert names.count("train.epoch") == 1 and names.count("train.step") == 3
    for child in ("train.shuffle", "train.step", "train.read_losses"):
        assert _inside(ev, child, "train.epoch"), child
    for child in ("train.rows", "train.forward", "train.backward", "train.optimizer"):
        assert names.count(child) == 3 and _inside(ev, child, "train.step"), child
    # the profiler mirrors a user-scope range on the device; a program span is no such range
    assert [e[4] for e in ev if e[0] == "outer"] == [True]
    assert not any(e[4] for e in ev if e[0].startswith("train."))


def test_serve_spans_nest_per_request_and_page(service):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        service.sample(100, seed=0)
        service.sample(600, seed=1)  # three pages of the largest bucket
        service.log_prob(np.zeros((10, 100), np.float32), np.zeros((10, 4), np.float32))
    ev = _events(prof)
    names = [e[0] for e in ev]
    assert names.count("serve.sample") == 2 and names.count("serve.log_prob") == 1
    assert names.count("serve.prepare") == 3
    for child in ("serve.lock", "serve.h2d", "serve.compute", "serve.d2h"):
        assert names.count(child) == 1 + 3 + 1, child
        assert all(any(p[0] in ("serve.sample", "serve.log_prob") and p[3] == c[3] and p[1] <= c[1] and c[2] <= p[2]
                       for p in ev) for c in ev if c[0] == child), child
    assert not any(e[4] for e in ev if e[0].startswith("serve."))


def test_train_counters_are_exact():
    trainer, state, x = _trainer(cap=3)  # 80 rows: 5 batches of 16, capped at 3
    before = instrument.snapshot()
    trainer.train_epoch(state, x, None, torch.Generator().manual_seed(1), 0)
    grown = instrument.since(before)
    assert (grown["train.steps"], grown["train.rows"]) == (3, 48)


@pytest.mark.parametrize("n, pages, computed", [(100, 1, 256), (600, 3, 768), (64, 1, 64)])
def test_serve_counters_are_exact(service, n, pages, computed):
    before = instrument.snapshot()
    assert service.sample(n, seed=0).shape == (n, 100)
    grown = instrument.since(before)
    assert (grown["serve.requests.sample"], grown["serve.rows"], grown["serve.pages"],
            grown["serve.rows_computed"]) == (1, n, pages, computed)
    assert grown.get("serve.requests.log_prob", 0) == 0


def test_log_prob_counts_one_page_of_its_bucket(service):
    before = instrument.snapshot()
    service.log_prob(np.zeros((70, 100), np.float32), np.zeros((70, 4), np.float32))
    grown = instrument.since(before)
    assert (grown["serve.requests.log_prob"], grown["serve.rows"], grown["serve.pages"],
            grown["serve.rows_computed"]) == (1, 70, 1, 256)


def test_packs_count_once_per_parameter_version():
    hac = HierarchicalAffineCoupling(dim=8, c_internal=(8, 4), impl="fused")
    hac.init(torch.Generator().manual_seed(0))
    before = instrument.get("hac.packs")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pk = hac_fused._packed(hac, CPU)
        assert hac_fused._packed(hac, CPU) is pk  # the same version: no repack
        hac_fused._bwd_weights(hac, pk)
        hac_fused._bwd_weights(hac, pk)
    assert instrument.get("hac.packs") == before + 1
    assert [e[0] for e in _events(prof)].count("hac.pack") == 2  # the flat weights, the backward's layout
    with torch.no_grad():
        next(hac.parameters()).add_(1.0)  # a new version in place
    assert hac_fused._packed(hac, CPU) is not pk
    assert hac_fused._packed(hac, CPU) is hac_fused._packed(hac, CPU)
    assert instrument.get("hac.packs") == before + 2


def test_since_reads_the_growth_of_every_counter():
    before = instrument.snapshot()
    instrument.count("test.a")
    instrument.count("test.a", 2)
    instrument.count("test.b", 0.5)
    grown = instrument.since(before)
    assert (grown["test.a"], grown["test.b"]) == (3, 0.5)
    assert instrument.get("test.never") == 0
