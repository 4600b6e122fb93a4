"""Max-likelihood training loop (port of ``hint_tpu/train/trainer.py``).

* one train step: Gaussian input noise σ=0.01 on x (at train and at eval
  time, train_unconditional.py:121,:81 of the reference), forward, loss =
  mean(½‖z‖²) − mean(log|det J|) (train_unconditional.py:128-129),
  backward, the clamped coupled-L2 Adam of ``train/optim.py``;
* epochs iterate data that lives on the device: a ``torch.randperm`` there,
  drop-last static slices and the ``max_batches_per_epoch`` cap; the loss
  terms of an epoch are stacked on the device and read once, at its end, so
  no step waits for the device;
* the state is mutable: the model holds the parameters, the optimizer the
  moments, and a step updates both in place;
* the permutation and the noise of epoch ``e`` come from generators derived
  from ``(seed, e)``, so a run resumed at epoch ``e`` draws what the
  uninterrupted run drew there;
* the model kind is explicit: ``"unconditional"`` and ``"cinn"`` train a
  ``Flow`` (the latter on ``z = f(x; y)``), ``"hint"`` a ``TwoLaneFlow`` on
  ``concat(z_x, z_y)`` with the full log-det (train_conditional.py:130-132);
  its x-lane-only NLL is read from the per-lane log-det;
* data parallelism: with a ``mesh`` (``hint_tpu_torch.parallel``) every rank
  holds the data, the parameters (broadcast from rank 0 at ``init_state``)
  and the same generators, so it draws the same permutation and the noise
  of the whole batch, then computes on its block of the batch's rows. The
  gradients of the trainable leaves and the loss terms go into one buffer
  and one all-reduce, divided by the number of ranks: the gradient of the
  mean loss over the whole batch, before the optimizer's clamp. The step
  is then the single-device step on the whole batch, as ``hint_tpu``'s
  batch-sharded step is. Checkpoints and the monitor run on rank 0 alone;
* spans (``utils.instrument``, seen while a profiler records):
  ``train.epoch``, with ``train.shuffle`` (the permutation and the gather)
  and ``train.read_losses`` (the epoch's one read) in it; ``train.step``,
  with ``train.rows`` (noise, shard), ``train.forward``, ``train.backward``
  and ``train.optimizer`` in it. Counters: ``train.steps`` and
  ``train.rows``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hint_tpu_torch.models.flow import Flow, TwoLaneFlow
from hint_tpu_torch.ops.base import exact_f32_matmul, resolve_device
from hint_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, broadcast, shard_batch
from hint_tpu_torch.train.optim import ClampedAdam, init_trainables, lr_schedule
from hint_tpu_torch.utils.instrument import count, span

NOISE_STD = 0.01  # train_unconditional.py:121

# model kinds (explicit, as in the JAX package)
UNCONDITIONAL = "unconditional"  # Flow, no condition
CONDITIONAL_CINN = "cinn"  # Flow with cond_dim > 0, z = f(x; y)
CONDITIONAL_HINT = "hint"  # TwoLaneFlow, (z_y, z_x) = f(y, x)

# streams of one epoch's random draws; the plot stream feeds a monitor that
# wants plots (monitor/plots.py) and nothing else
TRAIN_STREAM, TEST_STREAM, PLOT_STREAM = 0, 1, 2


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the parameters (in ``model``), Adam's
    moments and step (in ``opt``) and the number of finished epochs."""

    model: nn.Module
    opt: ClampedAdam
    epoch: int = 0


def _in_one_buffer(tensors, collective) -> None:
    """``collective`` of the tensors through one flat buffer, written back
    in place: one call however many tensors."""
    flat = collective(torch.cat([t.reshape(-1) for t in tensors]))
    torch._foreach_copy_(tensors, [v.view_as(t) for t, v in zip(tensors, flat.split([t.numel() for t in tensors]))])


def nll_terms(z: torch.Tensor, logdet: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two loss terms ['-log p(z)', '-log |det(J)|']."""
    return 0.5 * torch.sum(z**2, dim=1).mean(), -logdet.mean()


@dataclasses.dataclass
class Trainer:
    model: nn.Module
    kind: str
    lr_init: float = 0.01
    pre_low_lr: int = 3
    final_decay: float = 0.01
    n_epochs: int = 50
    adam_betas: Tuple[float, float] = (0.9, 0.95)
    l2_weight_reg: float = 0.0
    init_scale: float = 0.005
    batch_size: int = 1000
    max_batches_per_epoch: int = 100
    # data-parallel over the mesh's ranks; the device is then the mesh's
    mesh: Optional[Mesh] = None
    # which torch StepLR behaviour to reproduce after the warm-up (optim.py)
    lr_semantics: str = "legacy"
    # per-batch Gaussian input-noise std on x; a field so that parity tests
    # can switch it off and inject their own
    noise_std: float = NOISE_STD
    # CUDA unless named; the model is moved there
    device: Optional[object] = None

    def __post_init__(self):
        if self.kind not in (UNCONDITIONAL, CONDITIONAL_CINN, CONDITIONAL_HINT):
            raise ValueError(f"unknown trainer kind {self.kind!r}")
        if self.kind == CONDITIONAL_HINT and not isinstance(self.model, TwoLaneFlow):
            raise TypeError("kind='hint' requires a TwoLaneFlow model")
        if self.kind != CONDITIONAL_HINT and not isinstance(self.model, Flow):
            raise TypeError(f"kind={self.kind!r} requires a Flow model")
        if self.mesh is not None:
            if self.device is not None and torch.device(self.device) != self.mesh.device:
                raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        exact_f32_matmul()
        self.model.to(self.device)

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: int) -> TrainState:
        """Fresh parameters and zero moments. Drawn from a CPU generator, so
        one seed gives one init on every device; under a mesh, rank 0's
        parameters are broadcast to the others all the same, as DDP does."""
        generator = torch.Generator().manual_seed(seed)
        self.model.init(generator)
        if self.init_scale > 0:
            init_trainables(self.model, generator, self.init_scale)
        if self.mesh is not None:
            with torch.no_grad():
                _in_one_buffer(list(self.model.state_dict().values()), lambda flat: broadcast(flat, self.mesh))
        return TrainState(self.model, ClampedAdam(self.model, self.adam_betas, self.l2_weight_reg))

    def n_trainable_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.opt.params.values())

    def epoch_generator(self, seed: int, epoch: int, stream: int) -> torch.Generator:
        """The device generator of one epoch's train or test draws."""
        word = np.random.SeedSequence([seed, epoch, stream]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(word))

    def _lr(self, epoch: int) -> float:
        return lr_schedule(
            epoch, self.lr_init, self.pre_low_lr, self.final_decay, self.n_epochs, self.lr_semantics
        )

    # -- steps --------------------------------------------------------------------

    def _loss(self, x: torch.Tensor, y: Optional[torch.Tensor]):
        """Returns (total, stacked (term1, term2), nll_x or NaN)."""
        if self.kind != CONDITIONAL_HINT:
            z, logdet = self.model(x) if self.kind == UNCONDITIONAL else self.model(x, y)
            t1, t2 = nll_terms(z, logdet)
            return t1 + t2, torch.stack((t1, t2)), t1.new_full((), float("nan"))
        # two-lane conditional HINT: loss on concat(z_x, z_y) with the full logdet
        z_y, z_x, ld_y, ld_x = self.model(y, x)
        t1, t2 = nll_terms(torch.cat([z_x, z_y], dim=-1), ld_y + ld_x)
        # x-lane-only NLL from the per-lane logdet (train_conditional.py:134)
        nll_x = 0.5 * torch.sum(z_x**2, dim=1).mean() - ld_x.mean()
        return t1 + t2, torch.stack((t1, t2)), nll_x

    def _noisy(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return x + self.noise_std * noise

    def _rows(self, x, y, generator: torch.Generator):
        """The noisy batch, or under a mesh this rank's block of it: the
        noise is drawn for the whole batch on every rank, as ``hint_tpu``
        draws it before it shards."""
        x = self._noisy(x, generator)
        if self.mesh is None:
            return x, y
        return shard_batch(x, self.mesh), (shard_batch(y, self.mesh) if y is not None else None)

    def _mean_over_ranks(self, tensors):
        """Each tensor replaced in place by its mean over the mesh's ranks,
        through one buffer and one all-reduce."""
        _in_one_buffer(tensors, lambda flat: all_reduce_sum(flat, self.mesh).div_(self.mesh.size))

    def train_step(self, state: TrainState, x, y, generator: torch.Generator, lr: float) -> torch.Tensor:
        """One update in place from the batch (x, y); returns the two loss
        terms on the device. Under a mesh, (x, y) is the whole batch on
        every rank, and the terms are its means."""
        count("train.steps")
        count("train.rows", x.shape[0])
        with span("train.step"):
            with span("train.rows"):
                rows = self._rows(x, y, generator)
            with span("train.forward"):
                total, terms, _ = self._loss(*rows)
            with span("train.backward"):
                total.backward()
                terms = terms.detach()
                if self.mesh is not None:  # before the update's clamp: the whole batch's gradient
                    self._mean_over_ranks([p.grad for p in state.opt.params.values()] + [terms])
            with span("train.optimizer"):
                state.opt.update(lr)
        return terms

    @torch.no_grad()
    def eval_step(self, x, y, generator: torch.Generator) -> torch.Tensor:
        """The two loss terms and the x-lane NLL (NaN for single-lane
        models), stacked, on the device; means over the whole batch under
        a mesh as without."""
        _, terms, nll_x = self._loss(*self._rows(x, y, generator))
        out = torch.cat((terms, nll_x[None]))
        if self.mesh is not None:
            self._mean_over_ranks([out])
        return out

    # -- epoch loops ----------------------------------------------------------------

    def _batches(self, generator: torch.Generator, n: int, train: bool):
        """A permutation of the rows and the number of drop-last batches."""
        perm = torch.randperm(n, generator=generator, device=self.device)
        n_batches = n // self.batch_size
        if n_batches == 0 and train:
            # eval_epoch evaluates the whole set instead; a training epoch of
            # zero batches would be a silent no-op
            raise ValueError(
                f"dataset of {n} rows yields zero drop-last batches at "
                f"batch_size={self.batch_size}; shrink the batch or grow the data"
            )
        if self.max_batches_per_epoch > 0:
            n_batches = min(n_batches, self.max_batches_per_epoch)
        return perm, n_batches

    def _shuffled(self, x, y, generator, train: bool):
        """One gathered copy of (x, y) in a fresh order, cut to whole
        batches, and the number of batches."""
        perm, n_batches = self._batches(generator, x.shape[0], train)
        rows = perm[: n_batches * self.batch_size]
        return x[rows], (y[rows] if y is not None else None), n_batches

    def _epoch_slices(self, x, y, generator, train: bool, shuffled=None):
        """Shuffled (x, y) batches as static slices of one gathered copy
        (``shuffled``: that of ``_shuffled``, made already)."""
        x_sh, y_sh, n_batches = shuffled or self._shuffled(x, y, generator, train)
        for b in range(n_batches):
            s = slice(b * self.batch_size, (b + 1) * self.batch_size)
            yield x_sh[s], (y_sh[s] if y_sh is not None else None)

    def train_epoch(
        self, state: TrainState, x, y, generator: torch.Generator, epoch: int, monitor=None
    ) -> np.ndarray:
        """One epoch over device tensors; returns the mean loss terms."""
        lr = self._lr(epoch)
        losses = []
        with span("train.epoch"):
            with span("train.shuffle"):
                shuffled = self._shuffled(x, y, generator, True)
            for xb, yb in self._epoch_slices(x, y, generator, True, shuffled):
                losses.append(self.train_step(state, xb, yb, generator, lr))
                if monitor is not None:
                    monitor.update_progress(len(losses), epoch + 1)
            with span("train.read_losses"):
                return np.mean(torch.stack(losses).cpu().numpy(), axis=0)

    def eval_epoch(
        self, x, y, generator: torch.Generator, full_batch: bool = False, return_nll_x: bool = False
    ):
        """Test pass; ``full_batch=True`` (or a set smaller than one batch)
        evaluates the whole set as one batch (UCI test semantics).
        ``return_nll_x=True`` also returns the x-lane-only NLL of a two-lane
        model (the reference's ``x_jac`` metric, train_conditional.py:50-55,134);
        NaN for single-lane models."""
        if full_batch or x.shape[0] < self.batch_size:
            out = self.eval_step(x, y, generator).cpu().numpy()
        else:
            losses = [
                self.eval_step(xb, yb, generator)
                for xb, yb in self._epoch_slices(x, y, generator, False)
            ]
            out = np.mean(torch.stack(losses).cpu().numpy(), axis=0)
        return (out[:2], float(out[2])) if return_nll_x else out[:2]

    def fit(
        self,
        seed: int,
        train_data: Tuple,
        test_data: Tuple,
        monitor=None,
        full_batch_test: bool = False,
        checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
        resume_state: Optional[TrainState] = None,
    ) -> Tuple[TrainState, float]:
        """Full training run on (x, y) tensors that lie on ``self.device``;
        returns (state, final summed test loss). ``resume_state`` continues
        exactly from a loaded checkpoint (parameters, moments, epoch). Under
        a mesh, ``monitor`` and ``checkpoint_fn`` are called on rank 0
        only."""
        if self.mesh is not None and self.mesh.rank != 0:
            monitor = checkpoint_fn = None
        x_tr, y_tr = train_data
        x_te, y_te = test_data
        state = resume_state if resume_state is not None else self.init_state(seed)
        t_start = time.time()
        test_losses = np.zeros(2)
        if state.epoch >= self.n_epochs:  # resumed a finished run: just eval
            test_losses = self.eval_epoch(
                x_te, y_te, self.epoch_generator(seed, state.epoch, TEST_STREAM), full_batch_test
            )
        for epoch in range(state.epoch, self.n_epochs):
            train_losses = self.train_epoch(
                state, x_tr, y_tr, self.epoch_generator(seed, epoch, TRAIN_STREAM), epoch, monitor
            )
            test_losses = self.eval_epoch(
                x_te, y_te, self.epoch_generator(seed, epoch, TEST_STREAM), full_batch_test
            )
            state.epoch += 1
            if monitor is not None and getattr(monitor, "wants_plots", False):
                self._push_plots(x_te, y_te, self.epoch_generator(seed, epoch, PLOT_STREAM), monitor)
            if monitor is not None:
                monitor.update_losses(np.concatenate([train_losses, test_losses]), self._lr(epoch))
            if checkpoint_fn is not None:
                checkpoint_fn(state, epoch)
        if monitor is not None:
            monitor.finish((time.time() - t_start) / 60.0)
        return state, float(test_losses.sum())

    def _push_plots(self, x_te, y_te, generator: torch.Generator, monitor, n_vis: int = 512):
        """Per-epoch latent scatter of ``n_vis`` test rows and 64 inverse
        samples, for a conditional model at the conditions of the first 64
        test rows (fewer where the test set is smaller; the reference's
        test-pass visualization,
        train_unconditional.py:147-154). The passes run the model's kernels
        and raise as they would anywhere; only a failure of the drawing
        itself is reported and passed over, so that plots never end a run."""
        from hint_tpu_torch.evaluation.sampling import _randn, sample_conditional_hint

        xb = x_te[:n_vis]
        with torch.no_grad():
            if self.kind == UNCONDITIONAL:
                z, _ = self.model(xb)
                x_samp, _ = self.model.inverse(_randn(generator, 64, self.model.dim))
            elif self.kind == CONDITIONAL_CINN:
                yb = y_te[:n_vis]
                z, _ = self.model(xb, yb)
                x_samp, _ = self.model.inverse(_randn(generator, len(yb[:64]), self.model.dim), yb[:64])
            else:
                yb = y_te[:n_vis]
                _, z, _, _ = self.model(yb, xb)
                x_samp = sample_conditional_hint(self.model, yb[:64], generator)
        latent, x_np = z[:, :2].cpu().numpy(), x_samp.cpu().numpy()
        try:
            monitor.update_plots(latent, x_np)
        except Exception as exc:  # noqa: BLE001 - drawing only; the passes above are not caught
            print(f"plots skipped: {exc!r}")
