"""The plain reference against the program's plain (levelwise) path at a
tiny width on the CPU, and the benchmark's data model against the
program's. The tests may import both; the reference imports nothing of the
program."""

import math

import pytest
import torch

from hintbench.lib import program
from hintbench.lib import weights as W
from hintbench.lib.check import widest
from hintbench.reference import train as R
from hintbench.tests.conftest import tiny_cell

CONFIGS = ("hint4-train", "rcinn4-train")


def _pair(workload, scheme):
    cell = tiny_cell(workload)
    cfg = cell.config
    flow = cell.config_module.reference(cfg)
    model = program.config(cfg, strict=False).build_model(impl="levelwise", device="cpu")
    p = W.make(flow, 11, "cpu", scheme, cfg["init_scale"])
    model.load_state_dict(p, strict=True)
    return cfg, flow, model, p


@pytest.mark.parametrize("workload", CONFIGS)
@pytest.mark.parametrize("scheme", ["init", "serve"])
def test_reference_matches_levelwise_forward_and_inverse(workload, scheme):
    """Within twice the reference's own f32 error against float64, or 1e-6
    (the tiny widths make the ``serve`` weights large, and the flow
    ill-conditioned)."""
    cfg, flow, model, p = _pair(workload, scheme)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, cfg["ndim_x"], generator=g)
    c = torch.randn(64, cfg["ndim_y"], generator=g) if cfg["ndim_y"] else None
    p64 = {k: v.double() for k, v in p.items()}
    c64 = None if c is None else c.double()
    with torch.no_grad():
        z, ld = model(x, c) if c is not None else model(x)
        zr, ldr = flow.forward(p, x, c)
        z64, ld64 = flow.forward(p64, x.double(), c64)
        xi, ldi = model.inverse(z, c) if c is not None else model.inverse(z)
        xr, ldir = flow.inverse(p, z, c)
        x64, ldi64 = flow.inverse(p64, z.double(), c64)
    for a, b, exact in ((z, zr, z64), (ld, ldr, ld64), (xi, xr, x64), (ldi, ldir, ldi64)):
        assert widest(a, b) <= 2 * max(widest(b, exact), 1e-6), (widest(a, b), widest(b, exact))


@pytest.mark.parametrize("workload", CONFIGS)
def test_reference_gradients_match_levelwise(workload):
    cfg, flow, model, p = _pair(workload, "init")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(128, cfg["ndim_x"], generator=g)
    c = torch.randn(128, cfg["ndim_y"], generator=g) if cfg["ndim_y"] else None
    z, ld = model(x, c) if c is not None else model(x)
    R.nll(z, ld).backward()
    train = flow.trainable()
    q = {k: v.clone().requires_grad_(k in train) for k, v in p.items()}
    grads = torch.autograd.grad(R.nll(*flow.forward(q, x, c)), [q[k] for k in train])
    named = dict(model.named_parameters())
    for k, gr in zip(train, grads):
        assert torch.allclose(named[k].grad, gr, rtol=1e-4, atol=1e-7), k


def test_reference_adam_matches_the_programs_update():
    from hint_tpu_torch.train.optim import ClampedAdam

    cfg, flow, model, p = _pair("hint4-train", "init")
    g = torch.Generator().manual_seed(5)
    params = {k: v.clone() for k, v in p.items() if k in flow.trainable()}
    opt = ClampedAdam(model, tuple(cfg["adam_betas"]), cfg["l2_weight_reg"])
    ref = R.Adam(params, tuple(cfg["adam_betas"]), cfg["l2_weight_reg"])
    named = dict(model.named_parameters())
    for step in range(3):
        grads = {k: 3.0 * torch.randn(v.shape, generator=g) for k, v in params.items()}
        for k, gr in grads.items():
            named[k].grad = gr.clone()
        opt.update(3e-4)
        ref.update(params, grads, 3e-4)
    for k, v in params.items():
        assert torch.allclose(named[k].detach(), v, rtol=1e-6, atol=1e-9), k


def test_lr_schedule_matches_the_programs():
    from hint_tpu_torch.train.optim import lr_schedule

    cfg = tiny_cell("hint4-train").config
    for e in (0, 2, 3, 10, 49):
        assert math.isclose(R.lr_at(e, cfg), lr_schedule(e, cfg["lr_init"], cfg["pre_low_lr"], cfg["final_decay"],
                                                         cfg["n_epochs"]), rel_tol=1e-12)


def test_data_model_rows_match_the_programs_device_pipeline():
    """The benchmark's copy of the plus-shape pipeline gives the program's
    device rows for the same seed (the rows the program redraws on the host
    aside)."""
    from hint_tpu_torch.data import plus_tpu

    from hintbench.lib.plusdata import SUB_BATCH, generator, plus_rows

    x, y = plus_rows(1000, 21, "cpu")
    packed, _ = plus_tpu._sub_batch(generator(21, 0, "cpu"), SUB_BATCH, "cpu")
    packed = packed[:1000].numpy()
    keep = packed[:, plus_tpu.FLAG_COLUMN] == 0
    xp = plus_tpu._unpack_x(packed[:, :50])
    assert keep.mean() > 0.99
    assert torch.equal(x[torch.as_tensor(keep)], torch.as_tensor(xp[keep]))
    assert torch.equal(y[torch.as_tensor(keep)], torch.as_tensor(packed[keep, 50:54]))


def test_epoch_feed_matches_the_trainers():
    """The reference's batch order and input noise are the trainer's, from
    the same epoch generator."""
    cell = tiny_cell("hint4-train")
    cfg = cell.config
    trainer = program.config(cfg, strict=False).make_trainer(impl="levelwise", device="cpu")
    x = torch.randn(cfg["n_train"], cfg["ndim_x"], generator=torch.Generator().manual_seed(6))
    seen = []
    trainer.train_step = lambda state, xb, yb, gen, lr: (seen.append(trainer._noisy(xb, gen)), torch.zeros(2))[1]
    trainer.max_batches_per_epoch = 3
    trainer.train_epoch(None, x, None, torch.Generator().manual_seed(99), 0)
    ref = R.epoch_batches(torch.Generator().manual_seed(99), x, None, cfg["batch_size"], 3, 3)
    assert len(seen) == 3 and all(torch.equal(a, b) for a, (b, _) in zip(seen, ref))
