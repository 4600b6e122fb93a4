"""File-based live monitor (port of ``hint_tpu/monitor/plots.py``).

The reference's ``LiveVisualizer`` (monitoring.py:51-139) streams loss
trajectories, a 2-D latent scatter and a data-model shape plot to a visdom
server. Headless, the same views are PNG files in a run directory,
rewritten each epoch; the console keeps the shared loss table.

matplotlib is imported when a figure is drawn, never when this module is
imported: a CUDA host may lack matplotlib, and ``make_monitor``
(``monitor/console.py``) falls back to the console there.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from hint_tpu_torch.monitor.console import ConsoleMonitor


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_sample_curves(
    data_model, x: np.ndarray, path: str, y_target=None, n_bold: int = 3,
    show_forward: bool = True,
):
    """Shape plot matching the data models' ``update_plot`` (data.py:141-163,
    :253-276 of the reference): all curves faint, the last ``n_bold`` bold,
    the lens forward-process diameter in green, the plus-shape condition
    bars in translucent green."""
    plt = _mpl()
    from scipy.spatial.distance import pdist, squareform

    coeffs = data_model.unflatten_coeffs(np.asarray(x))
    points = data_model.trace_fourier_curves(coeffs)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.gca()
    faint = (0, 0, 0, min(1.0, 10.0 / len(points)))
    for i in range(len(points)):
        ax.plot(points[i, :, 0], points[i, :, 1], c=faint, zorder=1)
        if i >= len(points) - n_bold:
            ax.plot(points[i, :, 0], points[i, :, 1], c=(0, 0, 0))
            if show_forward and data_model.name.startswith("lens-shape"):
                d = squareform(pdist(points[i]))
                a, b = np.unravel_index(d.argmax(), d.shape)
                d0, d1 = points[i, a], points[i, b]
                ax.plot([d0[0], d1[0]], [d0[1], d1[1]], c=(0, 1, 0), ls="-", lw=1)
                ax.scatter([d0[0], d1[0]], [d0[1], d1[1]], c=[(0, 1, 0)], s=3, zorder=10)
    if show_forward and y_target is not None and data_model.name == "plus-shape":
        cx, cy, angle, ratio = y_target
        ax.plot(
            [cx - 100 * np.cos(angle), cx + 100 * np.cos(angle)],
            [cy - 100 * np.sin(angle), cy + 100 * np.sin(angle)],
            lw=30, color=(0, 1, 0, 0.1), zorder=-10,
        )
        ax.plot(
            [cx + 100 * np.sin(angle), cx - 100 * np.sin(angle)],
            [cy - 100 * np.cos(angle), cy + 100 * np.cos(angle)],
            lw=30 / ratio, color=(0, 1, 0, 0.1), zorder=-10,
        )
    ax.axvline(0, c="gray", ls=":", lw=0.5, zorder=-1)
    ax.axhline(0, c="gray", ls=":", lw=0.5, zorder=-1)
    ax.axis("equal")
    lo = min(-5, points[:, :, 0].min() - 1)
    hi = max(5, points[:, :, 0].max() + 1)
    lo2 = min(-5, points[:, :, 1].min() - 1)
    hi2 = max(5, points[:, :, 1].max() + 1)
    ax.axis([lo, hi, lo2, hi2])
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


class FileMonitor(ConsoleMonitor):
    """Console table + per-epoch PNGs: losses.png (trajectories, cf.
    monitoring.py:77-90), latent.png (2-D scatter of the first two z dims,
    :92-99), samples.png (data-model plot, :100-104)."""

    wants_plots = True

    def __init__(
        self,
        plot_dir: str,
        loss_labels: Optional[Sequence[str]] = None,
        data_model=None,
        y_target=None,
    ):
        super().__init__(loss_labels)
        self.plot_dir = plot_dir
        self.data_model = data_model
        self.y_target = y_target
        self.history: list = []
        os.makedirs(plot_dir, exist_ok=True)

    def update_losses(self, losses, lr=None):
        super().update_losses(losses, lr)
        self.history.append(np.asarray(losses, np.float64).ravel())
        plt = _mpl()
        hist = np.stack(self.history)
        fig = plt.figure(figsize=(7, 4))
        ax = fig.gca()
        half = self.n_losses // 2
        for i, label in enumerate(self.loss_labels):
            phase = "train" if i < half else "test"
            ls = "-" if i < half else "--"
            ax.plot(hist[:, i], ls, label=f"{phase} {label}")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        fig.savefig(os.path.join(self.plot_dir, "losses.png"), dpi=110, bbox_inches="tight")
        plt.close(fig)

    def update_plots(self, latent_sample, x_sample):
        plt = _mpl()
        z = np.asarray(latent_sample)
        fig = plt.figure(figsize=(4, 4))
        ax = fig.gca()
        ax.scatter(z[:, 0], z[:, 1], s=2, alpha=0.4)
        circle = plt.Circle((0, 0), 2.0, color="r", fill=False, ls=":")
        ax.add_patch(circle)
        ax.set_title("latent (dims 0,1)")
        ax.axis("equal")
        fig.savefig(os.path.join(self.plot_dir, "latent.png"), dpi=110, bbox_inches="tight")
        plt.close(fig)
        if self.data_model is not None and x_sample is not None:
            plot_sample_curves(
                self.data_model,
                np.asarray(x_sample),
                os.path.join(self.plot_dir, "samples.png"),
                y_target=self.y_target,
            )
