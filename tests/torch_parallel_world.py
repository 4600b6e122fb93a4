"""The port's side of ``tests/test_torch_port_parallel.py``: what every rank
of a 2-rank gloo world computes. ``hint_tpu_torch.parallel.dryrun.spawn``
runs ``run`` on each rank; it imports torch, numpy and the port only (the
ranks never import JAX), reads the inputs the test wrote to an npz, and
returns a flat dict of arrays. ``one_rank_mesh`` gives other test files a
1-rank world in their own process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import torch
import torch.distributed as dist

from hint_tpu_torch.configs import get_config
from hint_tpu_torch.evaluation import abc, shape_fit
from hint_tpu_torch.evaluation.mmd import multi_mmd
from hint_tpu_torch.evaluation.sampling import sample_model
from hint_tpu_torch.models import builders
from hint_tpu_torch.parallel import all_gather_rows, all_reduce_sum, init_world, make_mesh
from hint_tpu_torch.parallel.dryrun import dryrun, gather_bits
from hint_tpu_torch.train.optim import ClampedAdam
from hint_tpu_torch.train.trainer import UNCONDITIONAL, TrainState, Trainer

# the small model of tests/test_parallel.py and its hyper-parameters
DIM, N_BLOCKS, C_INTERNAL, BATCH = 12, 2, (16, 8), 64
L2, LR, BETAS = 1.86e-5, 1e-3, (0.9, 0.95)
STEPS = 3


def small_model():
    return builders.hint(DIM, N_BLOCKS, C_INTERNAL, device="cpu")


def _state(model) -> dict:
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _prefixed(prefix: str, tree: dict) -> dict:
    return {f"{prefix}:{k}": v for k, v in tree.items()}


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


class Recorder:
    """A monitor and a checkpoint function that count their calls."""

    wants_plots = False

    def __init__(self):
        self.calls = {"update_progress": 0, "update_losses": 0, "finish": 0, "checkpoint": 0}

    def update_progress(self, *args):
        self.calls["update_progress"] += 1

    def update_losses(self, *args):
        self.calls["update_losses"] += 1

    def finish(self, *args):
        self.calls["finish"] += 1

    def checkpoint(self, state, epoch):
        self.calls["checkpoint"] += 1


def _trainer(mesh, **kw):
    hyper = dict(kind=UNCONDITIONAL, batch_size=BATCH, max_batches_per_epoch=1, l2_weight_reg=L2,
                 adam_betas=BETAS, noise_std=0.0)
    return Trainer(model=small_model(), mesh=mesh, **{**hyper, **kw})


def _load(trainer, params) -> TrainState:
    """The injected parameters and fresh moments."""
    trainer.model.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    return TrainState(trainer.model, ClampedAdam(trainer.model, BETAS, L2))


def _training(mesh, inp, params) -> dict:
    out = {}
    tr = _trainer(mesh)
    tr.init_state(mesh.rank)  # rank 0's parameters reach every rank
    out.update(_prefixed("init", _state(tr.model)))
    state = _load(tr, params)
    gen = torch.Generator().manual_seed(0)
    for k in range(STEPS):
        out[f"terms{k}"] = tr.train_step(state, torch.from_numpy(inp["x_steps"][k]), None, gen, LR).numpy()
        if k == 0:
            out.update(_prefixed("params1", _state(tr.model)))
    out.update(_prefixed("params3", _state(tr.model)))

    # one rank's rows push some gradient entries past the clamp, the whole
    # batch's do not: Adam's first moment shows which was clamped
    state = _load(tr, params)
    out["clamp_terms"] = tr.train_step(state, torch.from_numpy(inp["x_clamp"]), None, gen, LR).numpy()
    out.update(_prefixed("clamp_mu", {k: v.numpy().copy() for k, v in state.opt.mu.items()}))
    out.update(_prefixed("clamp_params", _state(tr.model)))

    _load(tr, params)
    x_eval = torch.from_numpy(inp["x_eval"])
    out["eval_full"] = tr.eval_epoch(x_eval, None, gen, full_batch=True)
    tr.batch_size, tr.max_batches_per_epoch = BATCH // 2, 2
    out["eval_batched"] = tr.eval_epoch(x_eval, None, gen)
    out["eval_undivided_error"] = _error(lambda: tr.eval_epoch(x_eval[:63], None, gen, full_batch=True))
    tr.batch_size = 63
    out["step_undivided_error"] = _error(lambda: tr.train_step(state, x_eval[:63], None, gen, LR))

    recorder = Recorder()
    fit = _trainer(mesh, batch_size=32, n_epochs=2, noise_std=0.01)
    _, final = fit.fit(0, (x_eval, None), (x_eval, None), monitor=recorder, checkpoint_fn=recorder.checkpoint)
    out["fit_final"] = np.float64(final)
    out.update(_prefixed("calls", {k: np.int64(v) for k, v in recorder.calls.items()}))
    return out


def _sampling(mesh) -> dict:
    out = {}
    unconditional = small_model()
    unconditional.init(torch.Generator().manual_seed(3))
    two_lane_cfg = dataclasses.replace(get_config("lens_shape.conditional_hint_2_full"),
                                       c_internal=C_INTERNAL, hidden=16, hidden_y=8)
    rcinn_cfg = dataclasses.replace(get_config("plus_shape.conditional_recursive_cinn_4"),
                                    n_blocks=1, c_internal=C_INTERNAL)
    models = {"unconditional": (types.SimpleNamespace(is_conditional=False), unconditional, None)}
    for name, cfg in (("two_lane", two_lane_cfg), ("rcinn", rcinn_cfg)):
        model = cfg.build_model(device="cpu")
        model.init(torch.Generator().manual_seed(1))
        models[name] = (cfg, model, cfg.vis_y_target)
    with torch.no_grad():
        for model in (m for _, m, _ in models.values()):
            for p in model.parameters():
                p.mul_(0.5)  # a random chain at full init scale does not invert in float32
        for name, (cfg, model, y_target) in models.items():
            for n in (16, 11):
                for key, m in (("sharded", mesh), ("unsharded", None)):
                    gen = torch.Generator().manual_seed(7)
                    out[f"sample_{name}_{n}_{key}"] = sample_model(cfg, model, n, gen, y_target, mesh=m).numpy()
    return out


def _evaluation(mesh, inp) -> dict:
    out = {}
    for chunk in (333, 16_000_000):
        gt, thr = abc.quantile_ABC(inp["pool_x"], inp["pool_y"], inp["pool_target"], n=50, device_chunk=chunk,
                                   mesh=mesh)
        out[f"abc_{chunk}"], out[f"abc_{chunk}_threshold"] = gt, np.float64(thr)
    gt, _ = abc.quantile_ABC(inp["pool_x"], torch.from_numpy(inp["pool_y"]), inp["pool_target"], n=50,
                             device_chunk=333, mesh=mesh)
    out["abc_tensor_pool"] = gt
    for n in (64, 63):  # 63 rows do not divide over the ranks: unsharded
        out[f"mmd_{n}"] = multi_mmd(inp["mmd_x"][:n], inp["mmd_y"][:n], mesh=mesh).numpy()

    lens = inp["lens_curves"]
    outlines = shape_fit.lens_outlines_batch(shape_fit.fit_lens_shapes_batch(lens, device="cpu"), device="cpu")
    for key, m in (("sharded", mesh), ("unsharded", None)):
        dev = {"mesh": m, "device": "cpu"}
        out[f"lens_{key}"] = shape_fit.fit_lens_shapes_batch(lens, **dev)
        out[f"iou_{key}"], out[f"dice_{key}"] = shape_fit.iou_and_dice_batch(
            outlines, lens, resolution=64, chunk=3, **dev)  # the chunk rounds up to 4 under the mesh
    return out


def _mesh_itself(mesh) -> dict:
    rows = torch.full((mesh.rank + 1, 3), float(mesh.rank + 1))
    sub = make_mesh(1, device="cpu")  # a leading subgroup: rank 0 alone
    return {
        "subgroup": np.array([-1, -1] if sub is None else [sub.rank, sub.size]),
        "subgroup_sum": np.array([] if sub is None else all_reduce_sum(torch.ones(2), sub).numpy()),
        "gathered": all_gather_rows(rows, mesh).numpy(),
        "reduced": all_reduce_sum(torch.arange(4.0) * (mesh.rank + 1), mesh).numpy(),
        "mesh": np.array([mesh.rank, mesh.size, mesh.shape["data"]]),
        "backend_error": _error(lambda: make_mesh(backend="nccl", device="cpu")),
        "registry_device": np.array(str(get_config("plus_shape.unconditional_hint_4_full")
                                        .make_trainer(mesh=mesh).device)),
        **gather_bits(mesh),
    }


def run(mesh, inputs_path: str) -> dict:
    inp = dict(np.load(inputs_path))
    params = {k.split(":", 1)[1]: v for k, v in inp.items() if k.startswith("param:")}
    out = _mesh_itself(mesh)
    out.update(_training(mesh, inp, params))
    out.update(_sampling(mesh))
    out.update(_evaluation(mesh, inp))
    out.update(_prefixed("dryrun", dryrun(mesh)))
    return out


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A 1-rank gloo world in this process, and its mesh on the CPU."""
    init_world(0, 1, "gloo", dist.FileStore(str(tmp_path / "one_rank_store"), 1))
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
