"""Training monitors (port of ``hint_tpu/monitor/console.py``).

Console parity with the reference's ``Visualizer`` (monitoring.py:7-48):
fixed-width epoch/loss table with train | test halves. The reference's visdom
``LiveVisualizer`` (monitoring.py:51-139) needs a live server; headless, the
rich monitor writes matplotlib figures to files instead
(``hint_tpu_torch.monitor.plots.FileMonitor``). ``make_monitor`` mirrors
``monitoring.restart``'s graceful degradation (monitoring.py:141-146).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

DEFAULT_LOSS_LABELS = ["-log p(z)", "-log |det(J)|"]  # train_unconditional.py:162


class NullMonitor:
    wants_plots = False  # FileMonitor opts in; trainers skip plot work otherwise

    def update_losses(self, losses, lr=None):
        pass

    def update_progress(self, batch, epoch):
        pass

    def update_plots(self, latent_sample, x_sample):
        pass

    def finish(self, minutes: float):
        pass


class ConsoleMonitor(NullMonitor):
    """Epoch-indexed loss table (monitoring.py:17-37)."""

    def __init__(self, loss_labels: Optional[Sequence[str]] = None, print_fn=print):
        labels = list(loss_labels or DEFAULT_LOSS_LABELS)
        self.loss_labels = labels + labels  # train block then test block
        self.n_losses = len(self.loss_labels)
        self.epoch = 0
        self.col_width = max(13, *[len(l) + 2 for l in self.loss_labels])
        self._print = print_fn

    def update_losses(self, losses, lr=None):
        if self.epoch == 0:
            header = " Epoch |"
            for i, l in enumerate(self.loss_labels):
                if i == self.n_losses // 2:
                    header += "  |"
                header += f"{l:>{self.col_width}s}"
            self._print("\n" + header)
            self._print("-" * (8 + self.n_losses * self.col_width + 3))
        row = f"{self.epoch:>5d}  |"
        for i, l in enumerate(np.asarray(losses).ravel()):
            if i == self.n_losses // 2:
                row += "  |"
            row += f"{l: {self.col_width}.4e}"
        if lr is not None:
            row += f"   (lr={lr:.2e})"
        self._print(row)
        self.epoch += 1

    def print_config(self, cfg) -> None:
        self._print("Training configuration:")
        for k, v in sorted(vars(cfg).items() if hasattr(cfg, "__dict__") else cfg.items()):
            self._print(f"    {k:25}\t{v}")
        self._print("")

    def finish(self, minutes: float):
        self._print(f"\nTraining took {minutes:f} minutes\n")


def make_monitor(
    interactive: bool = False,
    loss_labels=None,
    plot_dir: Optional[str] = None,
    data_model=None,
    y_target=None,
):
    """Best available monitor: the file-plotting monitor if matplotlib
    imports and a plot_dir is given, else the console (cf.
    monitoring.py:141-146). matplotlib is imported here, where the choice
    is made: ``FileMonitor`` imports it only when it first draws."""
    if interactive and plot_dir is not None:
        try:
            import matplotlib  # noqa: F401
        except ImportError as exc:
            print(f"--plot-dir {plot_dir}: matplotlib unavailable ({exc}); console monitor only")
        else:
            from hint_tpu_torch.monitor.plots import FileMonitor

            return FileMonitor(plot_dir, loss_labels, data_model=data_model, y_target=y_target)
    return ConsoleMonitor(loss_labels)
