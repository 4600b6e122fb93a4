"""Paper-figure plotting, headless (port of ``hint_tpu/monitor/figures.py``).

Re-design of the reference's plot_data.py: the same figure set, rendered
with matplotlib Agg and saved to files (no ``plt.show()``), fed by the
port's models instead of exec-imported config modules. Model panels take
``(cfg, model, generator, ...)`` and sample through the flow's inverse
under ``torch.no_grad()`` on the generator's device (CUDA unless the caller
made a CPU generator); shape fits run there too. matplotlib is imported
when a figure is drawn, never when this module is imported (a CUDA host
may lack it).

* ``plot_dataset_example``      — 4 prior shapes + correlation matrix; also
  writes the ground-truth correlation ``data/{name}_corr.npy`` consumed by
  ``experiments.test_likelihood`` (plot_data.py:38-70, corr save :61-63);
* ``show_parameter_sensitivity``— grid perturbing single Fourier coefficients
  (plot_data.py:74-99);
* ``plot_model_unconditional``  — 4 model samples with fitted ideal shapes +
  |corr − corr_true| heatmap (plot_data.py:102-137);
* ``plot_model_conditional``    — conditional samples with condition overlay
  (plot_data.py:140-201);
* ``plot_model_conditional_abc``— model posterior vs ABC ground truth grid
  (plot_data.py:205-236);
* ``plot_fouriercurve_example`` — Fourier-order truncation illustration
  (plot_data.py:240-266). The reference traces a frog (data/frog.json);
  this one a duck (``monitor/assets/outline.json``, a copy of
  ``hint_tpu``'s), with a procedural blob where the asset is missing;
* ``metrics_illustration``      — IoU/Hausdorff explainer figure
  (plot_data.py:270-319), with the shapely boolean fills replaced by an
  even-odd raster fill (hint_tpu_torch.data.geometry).
* ``_data_stripe``              — bar whose width is in data units
  (replaces plot_data.py:16-34's Line2D subclass with a plain polygon
  patch), used for condition overlays.
"""

from __future__ import annotations

import os

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir: str, stem: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{stem}.png")
    fig.savefig(path, bbox_inches="tight", pad_inches=0.05, dpi=200)
    return path


_OUTLINE_ASSET = os.path.join(os.path.dirname(__file__), "assets", "outline.json")
_OUTLINE_CACHE: dict = {}


def example_outline(n: int = 120, seed: int = 7) -> np.ndarray:
    """Closed example outline in [0,1]² for the Fourier-order illustration.

    Loaded from a static traced-outline asset (a duck silhouette,
    ``monitor/assets/outline.json``) with the same ``{"points": [{"x":..,
    "y":..}]}`` schema and loading mechanism as the reference's hand-traced
    frog (plot_data.py:242-244, data/frog.json) — the asset's own point
    count wins over ``n``, exactly as the reference's fixed frog trace
    does. ``n``/``seed`` shape the procedural fallback used when the asset
    is missing. The parsed asset is cached across calls."""
    try:
        import json

        if "pts" not in _OUTLINE_CACHE:
            with open(_OUTLINE_ASSET) as f:
                points = json.load(f)["points"]
            _OUTLINE_CACHE["pts"] = np.array([[p["x"], p["y"]] for p in points])
        return _OUTLINE_CACHE["pts"].copy()
    except Exception:
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 2 * np.pi, n, endpoint=False)
        r = 0.42 + 0.13 * np.sin(3 * t + 0.7) + 0.08 * np.sin(7 * t + 2.1) + 0.03 * rng.standard_normal(1)
        x = 0.5 + r * np.cos(t) * (1 + 0.15 * np.sin(2 * t))
        y = 0.62 + r * np.sin(t) * (1 + 0.1 * np.cos(t))
        return np.stack([x, y], axis=1)


def _data_stripe(ax, p0, p1, width, color, zorder=0):
    """Bar from p0 to p1 whose WIDTH is in data units, as a polygon patch.

    The reference overlays these with a Line2D subclass that rescales its
    linewidth through the axes transform (plot_data.py:16-34). For our
    static headless figures a data-units-wide line segment is simply a
    rectangle in data space, so draw the rectangle — no transform hooks,
    and it stays correct if the axes are resized after the call.
    """
    from matplotlib.patches import Polygon

    p0 = np.asarray(p0, dtype=float)
    p1 = np.asarray(p1, dtype=float)
    d = p1 - p0
    norm = float(np.hypot(d[0], d[1])) or 1.0
    n = np.array([-d[1], d[0]]) * (0.5 * width / norm)
    ax.add_patch(
        Polygon(
            [p0 - n, p0 + n, p1 + n, p1 - n],
            closed=True,
            facecolor=color,
            edgecolor="none",
            zorder=zorder,
        )
    )


def _curve_axes(ax, limits):
    ax.axvline(0, c="gray", ls=":", lw=0.5, zorder=-1)
    ax.axhline(0, c="gray", ls=":", lw=0.5, zorder=-1)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.axis(limits)


def plot_dataset_example(
    model, limits=(-5, 4, -4, 5), n_samples: int = 10000, seed: int = 0, out_dir: str = "data"
) -> str:
    """4 example shapes (generator outline in red, Fourier trace in black) +
    prior correlation matrix; saves {name}_corr.npy (plot_data.py:38-70)."""
    plt = _mpl()
    np.random.seed(seed)
    x = model.sample_prior(n_samples, flat=True)
    fig = plt.figure(figsize=(15.3, 3))
    axes = fig.subplots(1, 5)
    for i in range(4):
        if model.name == "plus-shape":
            coords = model.generate_plus_shape()
            n_coeffs = 25
        else:
            coords = model.generate_lens_shape()
            n_coeffs = 5
        axes[i].fill(coords[:, 0], coords[:, 1], fc=(1, 1, 1, 0), ec=(1, 0, 0, 0.25), lw=2, zorder=-10)
        points = model.trace_fourier_curves(model.fourier_coeffs(coords, n_coeffs)[None])[0]
        axes[i].plot(points[:, 0], points[:, 1], c=(0, 0, 0), lw=1, zorder=1)
        _curve_axes(axes[i], limits)
    corr = np.corrcoef(x.T)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{model.name}_corr.npy"), corr)
    axes[4].imshow(corr, cmap="RdBu", interpolation="nearest")
    axes[4].set_xticks([]); axes[4].set_yticks([])
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0.02, hspace=0.01)
    path = _save(fig, out_dir, f"{model.name}_example")
    plt.close(fig)
    return path


def show_parameter_sensitivity(
    limits=(-4, 4, -4, 4), n_samples: int = 5, seed: int = 0, out_dir: str = "data"
) -> str:
    """Perturb one Fourier coefficient per row (plus shape) across columns
    (plot_data.py:74-99)."""
    plt = _mpl()
    from hint_tpu_torch.data.fourier import PlusShapeModel

    model = PlusShapeModel()
    np.random.seed(seed)
    coords = model.generate_plus_shape()
    fig = plt.figure(figsize=(9, 2 * n_samples))
    axes = fig.subplots(n_samples, 5)
    for i in range(n_samples):
        axes[i][0].fill(coords[:, 0], coords[:, 1], fc=(1, 1, 1, 0), ec=(1, 0, 0, 0.25), lw=2, zorder=-10)
        coeffs = model.fourier_coeffs(coords, 25)[None].copy()
        for j in range(5):
            points = model.trace_fourier_curves(coeffs)[0]
            axes[i][j].plot(points[:, 0], points[:, 1], c=(0, 0, 0), lw=1, zorder=1)
            _curve_axes(axes[i][j], limits)
            coeffs[0, i % 2, 18 + 3 * i // 2] += 0.1 * ((i + 1) % 2) + 0.1j * (i % 2)
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0, hspace=0.1)
    path = _save(fig, out_dir, "parameter_sensitivity")
    plt.close(fig)
    return path


def _sample(cfg, model, n: int, generator, y_target=None) -> np.ndarray:
    """n samples of x through the model's inverse, on the host."""
    import torch

    from hint_tpu_torch.evaluation.sampling import sample_model

    with torch.no_grad():
        return sample_model(cfg, model, n, generator, y_target=y_target).cpu().numpy()


def _fits(data_model, curves, device):
    """The fitted ideal shapes of a few curves, in one batch on ``device``:
    (params, outlines), outlines (B, K, P, 2), K segments of a plus shape or
    one lens outline (plot_data.py:118-127)."""
    import torch

    from hint_tpu_torch.evaluation import shape_fit

    curves = np.asarray(curves, np.float32)
    if data_model.name.startswith("lens-shape"):
        params = shape_fit.fit_lens_shapes_batch(curves, device=device)
        prototype = torch.as_tensor(shape_fit.lens_prototype())
        return params, shape_fit.lens_points(prototype, torch.as_tensor(params))[:, None].numpy()
    params = shape_fit.fit_plus_shapes_batch(curves, device=device)
    return params, shape_fit.plus_segments(torch.as_tensor(params)).numpy()


def _overlay_fit(ax, outlines):
    """A fitted ideal shape in translucent red (plot_data.py:118-127)."""
    for line in outlines:
        ax.plot(line[:, 0], line[:, 1], c=(1, 0, 0, 0.25), lw=2, zorder=-10)


def plot_model_unconditional(
    cfg, model, generator, limits=(-4, 4, -4, 4), n_samples: int = 10000,
    out_dir: str = "data", cache_dir: str = "data",
) -> str:
    """4 model samples with fitted ideal shapes + |corr − corr_true|
    (plot_data.py:102-137)."""
    plt = _mpl()
    data_model = cfg.data_model()
    x = _sample(cfg, model, n_samples, generator)
    coeffs = data_model.unflatten_coeffs(x)
    points = data_model.trace_fourier_curves(coeffs)
    _, outlines = _fits(data_model, points[:4], generator.device)
    fig = plt.figure(figsize=(15.3, 3))
    axes = fig.subplots(1, 5)
    for i in range(4):
        axes[i].plot(points[i, :, 0], points[i, :, 1], c=(0, 0, 0), lw=1, zorder=1)
        _curve_axes(axes[i], limits)
        _overlay_fit(axes[i], outlines[i])
    corr = np.corrcoef(x.T)
    f_corr = os.path.join(cache_dir, f"{data_model.name}_corr.npy")
    if os.path.exists(f_corr):  # |corr - GT| when the GT file exists
        corr = np.abs(corr - np.load(f_corr))
        axes[4].imshow(corr, cmap="Greys", vmin=0, vmax=1, interpolation="nearest")
    else:
        axes[4].imshow(corr, cmap="RdBu", interpolation="nearest")
    axes[4].set_xticks([]); axes[4].set_yticks([])
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0.02, hspace=0.01)
    path = _save(fig, out_dir, f"{cfg.suffix}_example")
    plt.close(fig)
    return path


def plot_model_conditional(
    cfg, model, generator, limits=(-4, 4, -4, 4), n_samples: int = 4000,
    out_dir: str = "data", cache_dir: str = "data",
) -> str:
    """Conditional samples with condition overlays + correlation diff
    (plot_data.py:140-201)."""
    plt = _mpl()
    from scipy.spatial.distance import pdist, squareform

    data_model = cfg.data_model()
    y_target = np.asarray(cfg.vis_y_target, np.float32)
    x = _sample(cfg, model, n_samples, generator, y_target=y_target)
    coeffs = data_model.unflatten_coeffs(x[:4])
    points = data_model.trace_fourier_curves(coeffs)
    lens = data_model.name.startswith("lens-shape")
    fits = None if lens else _fits(data_model, points, generator.device)
    fig = plt.figure(figsize=(15.3, 3))
    axes = fig.subplots(1, 5)
    for i in range(4):
        axes[i].plot(points[i, :, 0], points[i, :, 1], c=(0, 0, 0), lw=1, zorder=1)
        _curve_axes(axes[i], limits)
        if lens:
            d = squareform(pdist(points[i]))
            a, b = np.unravel_index(d.argmax(), d.shape)
            d0, d1 = points[i, a], points[i, b]
            axes[i].plot([d0[0], d1[0]], [d0[1], d1[1]], c=(0, 1, 0), ls=":", lw=3)
            p0 = (d0 + d1) / 2 + y_target[::-1] / 2
            p1 = (d0 + d1) / 2 - y_target[::-1] / 2
            axes[i].plot([p0[0], p1[0]], [p0[1], p1[1]], c=(1, 0, 0, 0.25), ls="-", lw=3, zorder=-11)
        else:
            fit_params = fits[0][i]
            _overlay_fit(axes[i], fits[1][i])
            cx, cy, angle, ratio = y_target
            xwidth, ywidth = float(fit_params[2]), float(fit_params[3])
            width = max(xwidth, ywidth) if ratio > 1 else min(xwidth, ywidth)
            _data_stripe(
                axes[i],
                (cx - 100 * np.cos(angle), cy - 100 * np.sin(angle)),
                (cx + 100 * np.cos(angle), cy + 100 * np.sin(angle)),
                width, color=(0.2, 1, 0.5, 0.1), zorder=-10,
            )
            _data_stripe(
                axes[i],
                (cx + 100 * np.sin(angle), cy - 100 * np.cos(angle)),
                (cx - 100 * np.sin(angle), cy + 100 * np.cos(angle)),
                width / ratio, color=(0.2, 1, 0.5, 0.1), zorder=-10,
            )
    corr = np.corrcoef(x.T)
    f_corr = os.path.join(cache_dir, f"{data_model.name}_corr_conditional.npy")
    if os.path.exists(f_corr):
        corr_true = np.load(f_corr)
        axes[4].imshow(np.abs(corr - corr_true), cmap="Greys", vmin=0, vmax=1, interpolation="nearest")
    else:
        axes[4].imshow(corr, cmap="RdBu", interpolation="nearest")
    axes[4].set_xticks([]); axes[4].set_yticks([])
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0.02, hspace=0.01)
    path = _save(fig, out_dir, f"{cfg.suffix}_example")
    plt.close(fig)
    return path


def plot_model_conditional_abc(
    cfg, model, generator, i: int = 0, limits=(-5, 4, -4, 5), n_samples: int = 1000,
    abc_dir: str = "abc", out_dir: str = "data",
) -> str:
    """Model posterior next to the cached ABC ground-truth posterior
    (plot_data.py:205-236)."""
    import pickle

    plt = _mpl()
    data_model = cfg.data_model()
    with open(os.path.join(abc_dir, data_model.name, f"{i:05}.pkl"), "rb") as f:
        y_target, gt_sample, _ = pickle.load(f)
    x = _sample(cfg, model, n_samples, generator, y_target=np.asarray(y_target).reshape(-1))
    fig = plt.figure(figsize=(6.2, 3))
    axes = fig.subplots(1, 2)
    for k, sample in enumerate((gt_sample[:n_samples], x)):
        coeffs = data_model.unflatten_coeffs(np.asarray(sample))
        points = data_model.trace_fourier_curves(coeffs)
        for j in range(len(points)):
            axes[k].plot(points[j, :, 0], points[j, :, 1], c=(0, 0, 0, min(1, 10 / len(points))), zorder=1)
        _curve_axes(axes[k], limits)
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0.02, hspace=0.01)
    path = _save(fig, out_dir, f"{cfg.suffix}_abc_{i:05}")
    plt.close(fig)
    return path


def plot_fouriercurve_example(out_dir: str = "data") -> str:
    """Outline → densified points → Fourier truncations (plot_data.py:240-266),
    on the procedural example outline."""
    plt = _mpl()
    from hint_tpu_torch.data.fourier import PlusShapeModel

    model = PlusShapeModel()
    points = example_outline()
    points_dense = model.densify_polyline(points, 0.012)
    Ms = [1, 3, 10, 20]
    coeffs = [model.fourier_coeffs(points, 2 * m + 1)[None] for m in Ms]
    curves = [model.trace_fourier_curves(c, 200)[0] for c in coeffs]
    fig = plt.figure(figsize=(9.5, 3))
    axes = fig.subplots(1, 3)
    axes[0].fill(points[:, 0], points[:, 1], fc=(0, 0, 0, 0.1), ec=(0, 0, 0, 0.5), lw=2, zorder=1)
    axes[1].plot(points[:, 0], points[:, 1], c=(1, 0, 0, 0.5), lw=1, zorder=1)
    axes[1].scatter(points_dense[:, 0], points_dense[:, 1], c=[(1, 0, 0)], s=1, zorder=1)
    axes[2].set_prop_cycle(plt.cycler("color", plt.cm.viridis(np.linspace(0.2, 0.9, len(Ms))[::-1])))
    for i, curve in enumerate(curves):
        axes[2].plot(curve[:, 0], curve[:, 1], lw=1, zorder=1, label=2 * Ms[i] + 1)
    axes[2].legend(loc="upper center", title="# Fourier terms", ncol=4, fontsize=9)
    for ax in axes:
        ax.set_xticks([]); ax.set_yticks([])
        ax.axis([-0.2, 1.2, -0.1, 1.3])
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0.02, hspace=0.01)
    path = _save(fig, out_dir, "general_example")
    plt.close(fig)
    return path


def metrics_illustration(out_dir: str = "data") -> str:
    """IoU fill + two-sided Hausdorff matchings (plot_data.py:270-319); the
    shapely boolean fills become even-odd raster masks."""
    plt = _mpl()
    from hint_tpu_torch.data import geometry
    from hint_tpu_torch.data.fourier import PlusShapeModel

    model = PlusShapeModel()
    points = example_outline()
    Ms = [4, 30]
    coeffs = [model.fourier_coeffs(points, 2 * m + 1)[None] for m in Ms]
    curves = [model.trace_fourier_curves(c, 200)[0] for c in coeffs]

    fig = plt.figure(figsize=(10, 5))
    axes = fig.subplots(1, 2)

    # IoU panel: raster masks of union / intersection
    res = 400
    lo = np.minimum(curves[0].min(0), curves[1].min(0)) - 0.05
    hi = np.maximum(curves[0].max(0), curves[1].max(0)) + 0.05
    xs = np.linspace(lo[0], hi[0], res)
    ys = np.linspace(lo[1], hi[1], res)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    in_a = geometry.points_in_polygon(pts, curves[0]).reshape(res, res)
    in_b = geometry.points_in_polygon(pts, curves[1]).reshape(res, res)
    union = (in_a | in_b).astype(float)
    inter = (in_a & in_b).astype(float)
    img = np.zeros((res, res, 4))
    img[union > 0] = (0.59, 0.75, 0.05, 1.0)  # union green
    img[inter > 0] = (0.89, 0.45, 0.22, 1.0)  # intersection orange
    axes[0].imshow(img, origin="lower", extent=[lo[0], hi[0], lo[1], hi[1]])
    axes[0].plot(curves[0][:, 0], curves[0][:, 1], c=(0, 0, 0), lw=2, zorder=3)
    axes[0].plot(curves[1][:, 0], curves[1][:, 1], c=(0, 0, 0), lw=1, zorder=3)

    # Hausdorff panel: nearest-point matchings both ways
    axes[1].plot(curves[0][:, 0], curves[0][:, 1], color="#E37238", lw=3, zorder=1)
    axes[1].plot(curves[1][:, 0], curves[1][:, 1], color="#96BF0D", lw=3, zorder=1)
    axes[1].scatter(curves[0][:, 0], curves[0][:, 1], color="#464646", s=4, zorder=3)
    axes[1].scatter(curves[1][:, 0], curves[1][:, 1], color="#464646", s=4, zorder=3)
    diffs = curves[0][None, :, :] - curves[1][:, None, :]
    dists = np.sqrt(np.sum(diffs * diffs, axis=-1))
    for i, j in enumerate(np.argmin(dists, axis=0)):
        axes[1].plot([curves[0][i, 0], curves[1][j, 0]], [curves[0][i, 1], curves[1][j, 1]],
                     color="#464646", lw=1, zorder=5)
    for i, j in enumerate(np.argmin(dists, axis=1)):
        axes[1].plot([curves[0][j, 0], curves[1][i, 0]], [curves[0][j, 1], curves[1][i, 1]],
                     color="#464646", lw=1, zorder=5)
    for ax in axes:
        ax.set_xticks([]); ax.set_yticks([])
        ax.set_frame_on(False)
        ax.axis("equal")
    fig.subplots_adjust(left=0.01, bottom=0.01, right=0.99, top=0.99, wspace=0.02, hspace=0.01)
    path = _save(fig, out_dir, "metrics_illustration")
    plt.close(fig)
    return path


# Categorical series colors keyed by block count (fixed assignment — the
# color follows the entity across every panel and size class).
_BLOCK_COLORS = {4: "#2a78d6", 8: "#eb6834", 16: "#1baf7a", 32: "#eda100"}
_DEPTH_POS = {0: 0, 1: 1, 2: 2, 3: 3, 9: 4}  # 9 encodes 'full'
_DEPTH_TICKS = ["0", "1", "2", "3", "full"]


def _ablation_axes(ax, ylabel):
    ax.set_xticks(range(len(_DEPTH_TICKS)))
    ax.set_xticklabels(_DEPTH_TICKS)
    ax.set_xlabel("recursion depth")
    ax.set_ylabel(ylabel)
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(axis="y", color="#e5e4e0", lw=0.8, zorder=0)
    ax.tick_params(colors="#52514e")


def plot_ablation_grid(cells, out_dir: str = os.path.join("artifacts", "figures")):
    """Plus-shape architecture-ablation figures: IoU and per-dim likelihood
    vs recursion depth, one line per block count, one figure per
    parameter-matching class (base / small / big).

    ``cells`` maps ``(kind, blocks, depth, size)`` to ``{"iou": [...],
    "ll": [...]}`` over seeds, as built by ``campaign.stage_report`` (depth 9
    encodes 'full'; kind 'inn' rows carry depth 0 and are drawn as flat
    reference lines, since an INN has no recursion axis). This is the visual
    companion to the reference's tabular study (run_experiments.py:29-88 +
    eval_shapes.py:67-133 — the reference never plotted it).

    Returns the list of written PNG paths.
    """
    plt = _mpl()
    paths = []
    for size in ("base", "small", "big"):
        hint = {k: v for k, v in cells.items() if k[0] == "hint" and k[3] == size}
        inn = {k: v for k, v in cells.items() if k[0] == "inn" and k[3] == size}
        if not hint:
            continue
        fig, axes = plt.subplots(1, 2, figsize=(9.6, 3.6))
        fig.patch.set_facecolor("#fcfcfb")
        for ax, metric, ylabel in ((axes[0], "iou", "IoU"),
                                   (axes[1], "ll", "per-dim log-likelihood (nats)")):
            for blocks in sorted({k[1] for k in hint}):
                pts = sorted(
                    (_DEPTH_POS[k[2]], v[metric])
                    for k, v in hint.items()
                    if k[1] == blocks and len(v[metric])
                    and not np.all(np.isnan(v[metric]))
                )
                if not pts:
                    continue
                xs = [p[0] for p in pts]
                mean = [float(np.nanmean(p[1])) for p in pts]
                std = [float(np.nanstd(p[1])) for p in pts]
                color = _BLOCK_COLORS.get(blocks, "#52514e")
                ax.errorbar(xs, mean, yerr=std, color=color, lw=2, marker="o",
                            ms=5, capsize=3, zorder=3, label=f"{blocks} blocks")
                ax.annotate(f"{blocks}", (xs[-1], mean[-1]),
                            textcoords="offset points", xytext=(6, 0),
                            color="#52514e", fontsize=8, va="center")
            for k, v in sorted(inn.items()):
                if not len(v[metric]) or np.all(np.isnan(v[metric])):
                    continue
                m = float(np.nanmean(v[metric]))
                ax.axhline(m, color="#52514e", lw=1, ls=(0, (4, 3)), zorder=2)
                ax.annotate(f"INN-{k[1]}", (0.02, m), xycoords=("axes fraction", "data"),
                            textcoords="offset points", xytext=(0, 3),
                            color="#52514e", fontsize=7)
            _ablation_axes(ax, ylabel)
        axes[0].legend(loc="lower right", fontsize=8, frameon=False)
        fig.suptitle(f"plus-shape ablation — {size} (mean ± std over seeds; "
                     "dashed: INN baselines)", fontsize=10, color="#0b0b0b")
        fig.tight_layout()
        paths.append(_save(fig, out_dir, f"ablation_{size}"))
        plt.close(fig)
    return paths
