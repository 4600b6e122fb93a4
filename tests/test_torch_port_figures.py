"""The port's figures, file monitor and plot hook against ``hint_tpu``'s:
``monitor/figures.py`` (the dataset panels' prior correlation bit-identical,
the example outline and the data-units stripe equal, every figure
function's file names), ``train --plot-dir`` on the CPU for each model
kind, ``make_monitor``'s fallback without matplotlib, ``Trainer._push_plots``
(a failing model pass raises; a failing drawing is passed over) and
``abc.check_mmd_kernels``. They draw with matplotlib, which a CUDA host
may lack; importing the modules does not need it
(``tests/test_torch_port_slice.py``). Tiny widths throughout.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")

import hint_tpu_torch.configs.registry_data as port_registry  # noqa: E402
from hint_tpu.data import fourier as jax_fourier  # noqa: E402
from hint_tpu.monitor import figures as jax_figures  # noqa: E402
from hint_tpu_torch import cli  # noqa: E402
from hint_tpu_torch.configs import get_config  # noqa: E402
from hint_tpu_torch.data import fourier  # noqa: E402
from hint_tpu_torch.evaluation import abc  # noqa: E402
from hint_tpu_torch.monitor import ConsoleMonitor, figures, make_monitor  # noqa: E402
from hint_tpu_torch.monitor.plots import FileMonitor  # noqa: E402

# a tiny config of each model kind and of each trainer branch of _push_plots
TINY = {
    "lens_shape.unconditional_inn_1": dict(hidden=8),
    "lens_shape.conditional_cinn_1": dict(hidden=8),
    "lens_shape.conditional_hint_1_full": dict(hidden=8, c_internal=(8, 4), max_splits=1, hidden_y=4),
    "plus_shape.conditional_cinn_4": dict(hidden=8, n_blocks=1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    for name, overrides in TINY.items():
        monkeypatch.setitem(port_registry.CONFIGS, name, {**port_registry.CONFIGS[name], **overrides})


def _model(name):
    """A tiny model of ``name`` on the CPU, from ``model.init`` with its
    subnet weights at the trainer's init scale."""
    trainer = get_config(name).make_trainer(device="cpu")
    trainer.init_state(0)
    return trainer.model


@pytest.mark.parametrize("family", ["lens", "plus"])
def test_dataset_example_corr_is_hint_tpus(tmp_path, family):
    """``plot_dataset_example`` writes hint_tpu's ``{name}_corr.npy`` bit for
    bit (the prior of the same numpy seed) and its PNG name."""
    port_model, jax_model = ((fourier.LensShapeModel(), jax_fourier.LensShapeModel()) if family == "lens"
                             else (fourier.PlusShapeModel(), jax_fourier.PlusShapeModel()))
    ref = jax_figures.plot_dataset_example(jax_model, n_samples=2000, out_dir=str(tmp_path / "jax"))
    got = figures.plot_dataset_example(port_model, n_samples=2000, out_dir=str(tmp_path / "port"))
    assert os.path.basename(got) == os.path.basename(ref) and os.path.getsize(got) > 0
    name = f"{port_model.name}_corr.npy"
    np.testing.assert_array_equal(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name))


def test_example_outline_and_data_stripe_are_hints_tpus(monkeypatch, tmp_path):
    np.testing.assert_array_equal(figures.example_outline(), jax_figures.example_outline())
    # without the asset, the procedural outline
    for mod in (figures, jax_figures):
        monkeypatch.setattr(mod, "_OUTLINE_ASSET", str(tmp_path / "missing.json"))
        monkeypatch.setattr(mod, "_OUTLINE_CACHE", {})
    np.testing.assert_array_equal(figures.example_outline(n=50, seed=3), jax_figures.example_outline(n=50, seed=3))
    plt = figures._mpl()
    fig, ax = plt.subplots()
    for mod in (figures, jax_figures):
        mod._data_stripe(ax, (0.0, 0.0), (10.0, 0.0), width=0.5, color=(0, 0, 0, 0.1))
        mod._data_stripe(ax, (1.0, -2.0), (-3.0, 4.0), width=1.5, color=(0, 0, 0, 0.1))
    port_a, port_b, jax_a, jax_b = (p.get_xy() for p in ax.patches)
    np.testing.assert_array_equal(port_a, jax_a)
    np.testing.assert_array_equal(port_b, jax_b)
    assert port_a[:, 1].min() == -0.25 and port_a[:, 1].max() == 0.25
    plt.close(fig)


def test_figure_functions_write_hint_tpus_file_names(tmp_path, tiny):
    """Every figure function of the port writes the file hint_tpu's writes
    (the model panels sampled through tiny CPU flows)."""
    out = str(tmp_path / "figs")
    gen = lambda: torch.Generator().manual_seed(4242)  # noqa: E731
    paths = [
        figures.plot_fouriercurve_example(out_dir=out),
        figures.metrics_illustration(out_dir=out),
        figures.show_parameter_sensitivity(n_samples=2, out_dir=out),
    ]
    for name in ("lens_shape.unconditional_inn_1", "lens_shape.conditional_cinn_1",
                 "lens_shape.conditional_hint_1_full", "plus_shape.conditional_cinn_4"):
        cfg = get_config(name)
        fn = figures.plot_model_conditional if cfg.is_conditional else figures.plot_model_unconditional
        paths.append(fn(cfg, _model(name), gen(), n_samples=64, out_dir=out, cache_dir=str(tmp_path)))
    cfg = get_config("lens_shape.conditional_cinn_1")
    os.makedirs(tmp_path / "abc" / "lens-shape1")
    with open(tmp_path / "abc" / "lens-shape1" / "00000.pkl", "wb") as f:
        pickle.dump((np.array([[2.0, -1.0]], np.float32), fourier.LensShapeModel().sample_prior(32), 0.1), f)
    paths.append(figures.plot_model_conditional_abc(cfg, _model(cfg.name), gen(), i=0, n_samples=32,
                                                    abc_dir=str(tmp_path / "abc"), out_dir=out))
    assert [os.path.basename(p) for p in paths] == [
        "general_example.png", "metrics_illustration.png", "parameter_sensitivity.png",
        "lens-shape1_unconditional-inn-1_example.png", "lens-shape1_conditional-cinn-1_example.png",
        "lens-shape1_conditional-hint-1-full_example.png", "plus-shape_conditional-cinn-4_example.png",
        "lens-shape1_conditional-cinn-1_abc_00000.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    cells = {("hint", 4, 0, "base"): {"iou": [0.8, 0.81], "ll": [3.5, 3.52]},
             ("inn", 16, 0, "base"): {"iou": [0.89], "ll": [3.65]},
             ("hint", 4, 1, "small"): {"iou": [0.84], "ll": [3.61]}}
    for grid in ({}, cells):
        got = figures.plot_ablation_grid(grid, out_dir=str(tmp_path / "port"))
        ref = jax_figures.plot_ablation_grid(grid, out_dir=str(tmp_path / "jax"))
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert [os.path.basename(p) for p in got] == ["ablation_base.png", "ablation_small.png"]


@pytest.mark.parametrize("name", ["lens_shape.unconditional_inn_1", "lens_shape.conditional_cinn_1",
                                  "lens_shape.conditional_hint_1_full"])
def test_train_plot_dir_writes_the_pngs(tmp_path, tiny, name, capsys):
    """``train --plot-dir`` on the CPU, 2 epochs: the loss table and the
    three PNGs of the file monitor, for each trainer kind."""
    plots = tmp_path / "plots"
    cli.main(["train", "--config", name, "--device", "cpu", "--epochs", "2", "--n-train", "64", "--n-test", "32",
              "--batch-size", "16", "--cache-dir", str(tmp_path / "data"), "--plot-dir", str(plots)])
    assert sorted(os.listdir(plots)) == ["latent.png", "losses.png", "samples.png"]
    assert "plots skipped" not in capsys.readouterr().out


def test_make_monitor_falls_back_to_the_console_without_matplotlib(tmp_path, monkeypatch, capsys):
    assert type(make_monitor(interactive=True, plot_dir=str(tmp_path))) is FileMonitor
    assert type(make_monitor(plot_dir=str(tmp_path))) is ConsoleMonitor
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monitor = make_monitor(interactive=True, plot_dir=str(tmp_path / "none"))
    assert type(monitor) is ConsoleMonitor and not monitor.wants_plots
    assert "matplotlib unavailable" in capsys.readouterr().out


def test_push_plots_raises_a_failing_pass_and_passes_over_a_failing_drawing(tmp_path, tiny, monkeypatch, capsys):
    name = "lens_shape.unconditional_inn_1"
    trainer = get_config(name).make_trainer(device="cpu")
    trainer.init_state(0)
    x = torch.randn(32, 20, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    monitor = FileMonitor(str(tmp_path), data_model=fourier.LensShapeModel())

    def drawing_fails(*a):
        raise ValueError("a figure could not be drawn")

    monkeypatch.setattr(monitor, "update_plots", drawing_fails)
    trainer._push_plots(x, None, gen, monitor)
    assert "plots skipped: ValueError" in capsys.readouterr().out

    def pass_fails(*a, **k):
        raise RuntimeError("the kernel failed")

    monkeypatch.setattr(trainer.model, "forward", pass_fails)
    with pytest.raises(RuntimeError, match="the kernel failed"):
        trainer._push_plots(x, None, gen, monitor)


def test_check_mmd_kernels_writes_its_png(tmp_path):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((40, 3)), rng.standard_normal((40, 3)) + 0.5
    path = abc.check_mmd_kernels(torch.from_numpy(x), y, out_path=str(tmp_path / "mmd_kernels.png"))
    assert path == str(tmp_path / "mmd_kernels.png") and os.path.getsize(path) > 0
