"""A training cell: the program's ``Trainer.train_epoch`` in a closed loop
of epochs over device-resident data, at the configuration's batch.

Set-up builds the trainer with the benchmark's weights, makes the data and
drives the very state the window then takes through its first
``check_steps`` steps, through ``train_epoch`` on the window's own data
and epoch generator (epoch 0, capped at those steps). Those steps are what
the plain reference follows. The window then runs whole epochs from epoch
1 on, until another epoch of the mean length would pass ``--seconds``.
"""

from __future__ import annotations

import math
import time

import torch

from hintbench.lib import weights as W
from hintbench.lib.plusdata import plus_rows
from hintbench.reference import train as R


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    return W.seeded(seed, 100 + epoch, device)


class TrainCell:
    def __init__(self, cfg: dict, traffic: dict, config_module, seed: int, device, strict: bool = True):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.flow = config_module.reference(cfg)
        self.work = config_module.work(cfg, True)
        self.strict = strict
        self.steps0 = traffic["check_steps"]

    # -- set-up --------------------------------------------------------------------------

    def setup(self) -> None:
        from hintbench.lib import program
        from hint_tpu_torch.train.optim import ClampedAdam
        from hint_tpu_torch.train.trainer import TrainState

        cfg = self.cfg
        pcfg = program.config(cfg, self.strict)
        self.trainer = pcfg.make_trainer(compute_dtype=cfg["compute_dtype"], impl=cfg["impl"], device=self.device)
        self.weights = W.make(self.flow, self.seed, self.device, "init", cfg["init_scale"])
        self.trainer.model.load_state_dict(self.weights, strict=True)
        self.state = TrainState(self.trainer.model,
                                ClampedAdam(self.trainer.model, tuple(cfg["adam_betas"]), cfg["l2_weight_reg"]))
        x, y = plus_rows(cfg["n_train"], self.seed, self.device)
        self.x, self.y = x, (y if cfg["ndim_y"] else None)
        self.first = self._first_steps()
        # the window's full-epoch gather, so that its memory is the allocator's already
        n = self.x.shape[0]
        del_me = self.x[torch.randperm(n, device=self.device)[: n // cfg["batch_size"] * cfg["batch_size"]]]
        del del_me
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _first_steps(self) -> dict:
        """The first steps through ``train_epoch``, each step's loss, the
        first gradient from the optimizer's state after one step, and each
        leaf's change after the last."""
        trainer, opt = self.trainer, self.state.opt
        before = {k: p.detach().clone() for k, p in opt.params.items()}
        losses, grad = [], {}
        step = trainer.train_step
        b1 = opt.betas[0]

        def recorded(state, x, y, generator, lr):
            terms = step(state, x, y, generator, lr)
            losses.append(terms.detach().clone())
            if len(losses) == 1:
                grad.update({k: m / (1 - b1) for k, m in opt.mu.items()})
            return terms

        trainer.train_step = recorded
        trainer.max_batches_per_epoch = self.steps0
        try:
            trainer.train_epoch(self.state, self.x, self.y, epoch_generator(self.seed, 0, self.device), 0)
        finally:
            del trainer.train_step
            trainer.max_batches_per_epoch = self.cfg["max_batches_per_epoch"]
        return {"losses": [v.tolist() for v in losses], "grad": grad,
                "change": {k: p.detach() - before[k] for k, p in opt.params.items()}}

    # -- the window ------------------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        done, failed, per = 0, 0, self.cfg["max_batches_per_epoch"]
        t0 = time.perf_counter()
        while True:
            terms = self.trainer.train_epoch(self.state, self.x, self.y,
                                             epoch_generator(self.seed, done + 1, self.device), done + 1)
            done += 1
            failed += 0 if all(math.isfinite(float(v)) for v in terms) else per
            elapsed = time.perf_counter() - t0
            if elapsed * (done + 1) / done > seconds:  # another epoch of the mean length would pass it
                break
        return {"steps": done * per, "failed": failed, "seconds": time.perf_counter() - t0,
                "rows": done * per * self.cfg["batch_size"]}

    def release(self) -> None:
        """Free the program's state: what the check needs is kept."""
        del self.state, self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the plain reference ------------------------------------------------------------------

    def reference(self, mode: str = "float32", half: bool = False) -> dict:
        """The reference's own first steps from the same weights and batches
        (``half``: the fault that leaves half of each batch out)."""
        cfg, flow = self.cfg, self.flow
        dt = torch.float64 if mode == "float64" else torch.float32
        p = {k: v.detach().to(dt).clone() for k, v in self.weights.items()}
        train = flow.trainable()
        opt = R.Adam({k: p[k] for k in train}, tuple(cfg["adam_betas"]), cfg["l2_weight_reg"])
        B = cfg["batch_size"]
        feed = R.epoch_batches(epoch_generator(self.seed, 0, self.device), self.x, self.y, B, self.steps0,
                               self.steps0)
        losses, grad = [], {}
        for i, (xb, yb) in enumerate(feed):
            if half:
                xb, yb = xb[: B // 2], (None if yb is None else yb[: B // 2])
            xb, yb = xb.to(dt), (None if yb is None else yb.to(dt))
            for k in train:
                p[k].requires_grad_(True)
            terms = R.nll_terms(*flow.forward(p, xb, yb, mode))
            loss = terms[0] + terms[1]
            grads = torch.autograd.grad(loss, [p[k] for k in train])
            for k in train:
                p[k] = p[k].detach()
            opt.update({k: p[k] for k in train}, dict(zip(train, grads)), R.lr_at(0, cfg))
            losses.append([float(t.detach()) for t in terms])
            if i == 0:
                grad = {k: opt.mu[k] / (1 - opt.betas[0]) for k in train}
        return {"losses": losses, "grad": grad,
                "change": {k: p[k] - self.weights[k].to(dt) for k in train}}
