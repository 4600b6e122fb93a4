"""The port's evaluation path against the JAX package: the native
generator, the toy-data engines, the multi-kernel MMD, quantile-ABC, the
model comparisons, shape fitting and scoring, the experiment drivers and
the ``experiment`` subcommand's parser.

Inputs come from numpy with a seed and go through both packages, on the
CPU. Tolerances, each with its reason:

* the native generator, the prior pools, the toy-data caches, RANSAC angles
  and the cached metrics of ``collect-uci``: bit-identical (the same C++
  source or the same numpy code);
* ``multi_mmd``: 1e-5 relative (float32 Grams and kernel sums in other
  orders; the samples differ in distribution so the estimate is not a
  small difference of large terms);
* quantile-ABC: equal indices and threshold (the distances are the same
  float32 operations: fused multiply-adds in column order); ties go to the
  lower pool row, a stable argsort of the pool's distances;
* comparisons: the same pickle keys, equal ground truth, MMDs 1e-5 relative;
* outlines: 1e-6 absolute (float32 rotations, fused or not);
* IoU/DICE rasters: 0.5 % (float32 grids built in another order can move a
  boundary pixel);
* shape fits: ``FIT_TOL`` on the per-restart losses and the chosen
  parameters after 400 (plus) or 100 (lens) float32 SGD steps from the same
  start (measured, see the constant);
* shape scores through ``eval-shapes``: ``SCORE_TOL``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu import cli as jax_cli
from hint_tpu import experiments as jax_experiments
from hint_tpu.data import fourier as jax_fourier
from hint_tpu.data import loaders as jax_loaders
from hint_tpu.data import native as jax_native
from hint_tpu.evaluation import abc as jax_abc
from hint_tpu.evaluation import shape_fit as jax_fit
from hint_tpu.evaluation.mmd import multi_mmd as jax_mmd
from hint_tpu_torch import cli, experiments
from hint_tpu_torch.data import fourier, loaders, native
from hint_tpu_torch.evaluation import abc, shape_fit
from hint_tpu_torch.evaluation.mmd import multi_mmd
from torch_parallel_world import one_rank_mesh

# measured on 8 clean curves each, seeds 5-7: parameters at most 4.8e-7
# and restart losses 3.0e-8 apart, plus and lens (float32 SGD; elementwise
# products against XLA's fused ones)
FIT_TOL = 1e-5
# mean [IoU, DICE, max_h, avg_h] of 5 scored curves: measured at most 1.5e-6
# apart (a raster pixel in one curve's IoU, ~1e-5); 1e-4 allows a few pixels
SCORE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this file: its tests run many small ops (400
    SGD steps of a shape fit, short training runs), which slow down by
    orders of magnitude when every test worker of a shared machine spreads
    each op over all of its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean_curves(model_cls, n, seed):
    np.random.seed(seed)
    model = model_cls()
    x, _ = model.sample_joint(n)
    return model.trace_fourier_curves(model.unflatten_coeffs(x)).astype(np.float32)


# -- native generator -------------------------------------------------------------------


def test_native_generator_is_bit_identical_to_hint_tpus():
    assert native.available() and native._LIB_PATH != os.path.abspath(jax_native._LIB_PATH)
    assert os.path.dirname(native._LIB_PATH).endswith(os.path.join("hint_tpu_torch", "native"))
    for name in ("plus-shape", "lens-shape"):
        for seed in (0, 7):
            x, y = native.sample_joint(name, 48, seed=seed)
            xr, yr = jax_native.sample_joint(name, 48, seed=seed)
            np.testing.assert_array_equal(x, xr)
            np.testing.assert_array_equal(y, yr)
    target = native.sample_joint("plus-shape", 1, seed=3)[1][0]
    xc, yc = native.sample_plus_conditional(target, 6, tol=0.3, seed=1, max_trials=400_000)
    xcr, ycr = jax_native.sample_plus_conditional(target, 6, tol=0.3, seed=1, max_trials=400_000)
    assert len(xc) == 6 and np.all(np.linalg.norm(yc - target, axis=1) < 0.3)
    np.testing.assert_array_equal(xc, xcr)
    np.testing.assert_array_equal(yc, ycr)
    rng = np.random.default_rng(0)
    for _ in range(10):
        r0 = 1 + rng.random()
        lens = (0.0, 0.0, r0, 0.8 * 3 * r0 * np.sin(1.0), 0.8 * 3 * r0 * np.cos(1.0), 2 * r0)
        np.testing.assert_array_equal(native.lens_ring(*lens), jax_native.lens_ring(*lens))
        plus = (3 + 2 * rng.random(), 3 + 2 * rng.random(), 0.5 + rng.random(), 0.5 + rng.random(),
                rng.random() - 0.5, rng.random() - 0.5)
        np.testing.assert_array_equal(native.plus_outline(*plus), jax_native.plus_outline(*plus))
    with pytest.raises(ValueError, match="unknown data model"):
        native.sample_joint("fourier-curve", 2)


@pytest.mark.parametrize("engine", ["native", "numpy", "auto"])
def test_prepare_toy_data_engines_match_hint_tpu(tmp_path, engine):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    np.random.seed(4)
    (x, y), (xt, yt) = loaders.prepare_toy_data(fourier.LensShapeModel(), 24, 8, ours, engine=engine)
    np.random.seed(4)
    (xr, yr), (xtr, ytr) = jax_loaders.prepare_toy_data(jax_fourier.LensShapeModel(), 24, 8, theirs, engine=engine)
    for a, b in ((x, xr), (y, yr), (xt, xtr), (yt, ytr)):
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "lens-shape1_x_test.npy", "lens-shape1_x_train.npy", "lens-shape1_y_test.npy", "lens-shape1_y_train.npy"]
    if engine != "numpy":  # the native generator's train (0) and test (1) streams
        np.testing.assert_array_equal(x, native.sample_joint("lens-shape1", 24, seed=0)[0])
        np.testing.assert_array_equal(yt, native.sample_joint("lens-shape1", 8, seed=1)[1])
    with pytest.raises(ValueError, match="unknown engine"):
        loaders.prepare_toy_data(fourier.LensShapeModel(), 4, 4, ours, engine="tpu")


# -- MMD ------------------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [4, 100])
def test_multi_mmd_matches_hint_tpu(dim, tmp_path):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((300, dim)).astype(np.float32)
    y = (0.8 * rng.standard_normal((300, dim)) + 0.3).astype(np.float32)
    ref = float(jax_mmd(jnp.asarray(x), jnp.asarray(y)))
    got = multi_mmd(x, y, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(float(got), ref, rtol=1e-5, atol=0)
    assert float(multi_mmd(torch.from_numpy(x), torch.from_numpy(x))) < 1e-5 < ref
    widths = ((1.0, 0.5), (0.3, 2.0))
    np.testing.assert_allclose(float(multi_mmd(x, y, widths, device="cpu")),
                               float(jax_mmd(jnp.asarray(x), jnp.asarray(y), widths)), rtol=1e-5)
    with one_rank_mesh(tmp_path) as mesh:  # the sharded path over one rank
        np.testing.assert_allclose(float(multi_mmd(x, y, mesh=mesh)), ref, rtol=1e-5, atol=0)


# -- quantile ABC and the prior pool ---------------------------------------------------------


def test_quantile_abc_matches_hint_tpu_across_device_chunks(tmp_path):
    rng = np.random.default_rng(11)
    y = rng.standard_normal((50_000, 4)).astype(np.float32)
    rows = np.arange(50_000, dtype=np.float32)[:, None]  # the selection's pool rows
    target = rng.standard_normal(4).astype(np.float32)
    ref, ref_thr = jax_abc.quantile_ABC(rows, y, target, n=4000, device_chunk=12_345)
    for pool in (y, torch.from_numpy(y)):  # chunks uploaded, or sliced where the pool lies
        got, thr = abc.quantile_ABC(rows, pool, target, n=4000, device_chunk=12_345, device="cpu")
        np.testing.assert_array_equal(got, ref)
        assert thr == ref_thr
    # the float32 distances of hint_tpu's chunk_topk, bit for bit, and a
    # stable argsort of them, the nearest row dropped
    d = abc.chunk_distances(torch.from_numpy(y), torch.from_numpy(target[None])).numpy()
    ref_d = jax.jit(lambda yc, yt: jnp.sqrt(jnp.sum((yc - yt) ** 2, axis=1)))(jnp.asarray(y), jnp.asarray(target[None]))
    np.testing.assert_array_equal(d, np.asarray(ref_d))
    np.testing.assert_array_equal(got[:, 0].astype(np.int64), np.argsort(d, kind="stable")[1:4001])
    # tied distances go to the lower row, in one chunk or across chunks, also
    # where a tie straddles the k-th row of a chunk
    tied = np.repeat(y[:50], 40, axis=0)
    d = abc.chunk_distances(torch.from_numpy(tied), torch.from_numpy(target[None])).numpy()
    for chunk in (2000, 77):
        got, thr = abc.quantile_ABC(np.arange(2000)[:, None], tied, target, n=100, device_chunk=chunk, device="cpu")
        np.testing.assert_array_equal(got[:, 0], np.argsort(d, kind="stable")[1:101])
        assert thr == np.sort(d)[101]
    with one_rank_mesh(tmp_path) as mesh:  # the sharded path over one rank
        got, thr = abc.quantile_ABC(rows, y, target, n=4000, device_chunk=12_345, mesh=mesh)
    np.testing.assert_array_equal(got, ref)
    assert thr == ref_thr


def test_prepare_samples_pool_is_hint_tpus(tmp_path, monkeypatch):
    """The native pool, drawn by spawned workers, equals hint_tpu's row for
    row (the same chunk seeds), and its cache is reused. The device sweep
    (``engine="tpu"``, held in tests/test_torch_port_sweep.py) needs a card
    unless the caller names the CPU."""
    x, y = abc.prepare_samples(fourier.LensShapeModel, n_total=50, chunk=20, out_dir=str(tmp_path / "port"),
                               n_workers=2, engine="native")
    xr, yr = jax_abc.prepare_samples(jax_fourier.LensShapeModel, n_total=50, chunk=20,
                                     out_dir=str(tmp_path / "jax"), n_workers=2, engine="native")
    assert x.shape == (60, 20) and y.shape == (60, 2)  # rounded up to whole chunks
    np.testing.assert_array_equal(np.asarray(x), np.asarray(xr))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(yr))
    assert sorted(os.listdir(tmp_path / "port")) == ["lens-shape1_x_huge.npy", "lens-shape1_y_huge.npy"]
    x2, _ = abc.prepare_samples(fourier.LensShapeModel, n_total=40, chunk=20, out_dir=str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        abc.prepare_samples(fourier.LensShapeModel, n_total=10, out_dir=str(tmp_path / "t"), engine="tpu")
    # the pool's distance histograms against the MMD kernels (drawn on the host)
    assert os.path.getsize(abc.check_mmd_kernels(x[:30], x[30:], out_path=str(tmp_path / "kernels.png"))) > 0


# -- comparisons ----------------------------------------------------------------------------


def _pools(tmp_path, model, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, model.n_parameters)).astype(np.float32)
    y = rng.standard_normal((n, model.n_observations)).astype(np.float32)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        np.save(tmp_path / side / f"{model.name}_x_huge.npy", x)
        np.save(tmp_path / side / f"{model.name}_y_huge.npy", y)
    return str(tmp_path / "port"), str(tmp_path / "jax")


def _assert_same_results(got, ref, keys):
    assert set(got) == set(ref)
    for name in ref:
        assert set(got[name]) == set(ref[name]) == keys
        np.testing.assert_allclose(got[name]["mmds"], ref[name]["mmds"], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(got[name]["rejects"], ref[name]["rejects"])
        if "dists" in keys:
            np.testing.assert_allclose(got[name]["dists"], ref[name]["dists"], rtol=1e-6)


def test_compare_unconditional_matches_hint_tpu(tmp_path):
    model = fourier.LensShapeModel()
    ours, theirs = _pools(tmp_path, model)
    samplers = {"scaled": lambda z: 0.9 * z + 0.1, "torch": lambda z: torch.from_numpy(z) * 1.5}
    jax_samplers = {"scaled": samplers["scaled"], "torch": lambda z: z * 1.5}
    got = abc.compare_unconditional(model, samplers, n_runs=2, sample_size=64, abc_dir=ours, seed=3,
                                    verbose=False, device="cpu")
    ref = jax_abc.compare_unconditional(jax_fourier.LensShapeModel(), jax_samplers, n_runs=2, sample_size=64,
                                        abc_dir=theirs, seed=3, verbose=False)
    _assert_same_results(got, ref, {"times", "mmds", "rejects"})
    with open(os.path.join(ours, "lens-shape1_unconditional_comparison_0.pkl"), "rb") as f:
        _assert_same_results(pickle.load(f), ref, {"times", "mmds", "rejects"})


@pytest.mark.parametrize("model_name", ["LensShapeModel", "PlusShapeModel"])
def test_compare_conditional_matches_hint_tpu(tmp_path, model_name):
    model, jax_model = getattr(fourier, model_name)(), getattr(jax_fourier, model_name)()
    ours, theirs = _pools(tmp_path, model)

    def sampler(y_tiled, z):  # deterministic, and a little off the posterior
        return 0.5 * z + 0.01 * np.asarray(y_tiled).sum()

    np.random.seed(9)  # the targets come from the models' joint samplers
    got = abc.compare_conditional(model, {"m": sampler}, n_runs=3, sample_size=32, abc_dir=ours, seed=5,
                                  verbose=False, checkpoint_every=2, device="cpu")
    np.random.seed(9)
    ref = jax_abc.compare_conditional(jax_model, {"m": sampler}, n_runs=3, sample_size=32, abc_dir=theirs,
                                      seed=5, verbose=False, checkpoint_every=2)
    _assert_same_results(got, ref, {"times", "mmds", "dists", "rejects"})
    assert np.isnan(got["m"]["dists"]).all() == (model_name == "PlusShapeModel")
    for i in range(3):  # the ground-truth posteriors: same target, rows and threshold
        with open(os.path.join(ours, model.name, f"{i:05}.pkl"), "rb") as f, \
                open(os.path.join(theirs, model.name, f"{i:05}.pkl"), "rb") as g:
            (t, gt, thr), (tr, gtr, thrr) = pickle.load(f), pickle.load(g)
        np.testing.assert_array_equal(t, tr)
        np.testing.assert_array_equal(gt, gtr)
        assert thr == thrr
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    # the sweep reads its cached ground truth back
    again = abc.compare_conditional(model, {"m": sampler}, n_runs=3, sample_size=32, abc_dir=ours, seed=5,
                                    verbose=False, device="cpu")
    np.testing.assert_array_equal(again["m"]["mmds"], got["m"]["mmds"])


def test_accumulate_metrics_reads_hint_tpus_pickles(tmp_path, capsys):
    for i in range(3):
        with open(tmp_path / f"toy_conditional_comparison_{i}.pkl", "wb") as f:
            pickle.dump({"m": {"mmds": [0.1 * (i + 1), 0.2 * (i + 1)], "times": [0.0, 0.0]}}, f)
    ours = abc.accumulate_metrics("toy", True, ["m", "absent"], abc_dir=str(tmp_path))
    ref = jax_abc.accumulate_metrics("toy", True, ["m", "absent"], abc_dir=str(tmp_path))
    assert ours["m"] == ref["m"] and np.isnan(ours["absent"][0]) and np.isnan(ref["absent"][0])
    out = capsys.readouterr().out
    assert out[: len(out) // 2] == out[len(out) // 2 :]


# -- shape fitting --------------------------------------------------------------------------


def test_ransac_outlines_and_prototype_match_hint_tpu():
    curves = _clean_curves(fourier.PlusShapeModel, 12, seed=2)
    np.testing.assert_array_equal(shape_fit.dominant_angles_ransac_batch(curves),
                                  jax_fit.dominant_angles_ransac_batch(curves))
    np.testing.assert_array_equal(shape_fit.lens_prototype(), jax_fit.lens_prototype())
    rng = np.random.default_rng(1)
    plus = np.concatenate([rng.uniform(0.5, 5, (16, 6)), rng.uniform(-1, 1, (16, 2)),
                           rng.uniform(-3, 3, (16, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(shape_fit.plus_outlines_batch(plus, device="cpu"),
                               jax_fit.plus_outlines_batch(plus), rtol=0, atol=1e-6)
    lens = np.concatenate([rng.uniform(-1, 1, (16, 2)), rng.uniform(0.5, 3, (16, 1)),
                           rng.uniform(-3, 3, (16, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(shape_fit.lens_outlines_batch(lens, device="cpu"),
                               jax_fit.lens_outlines_batch(lens), rtol=0, atol=1e-6)
    # ±0.01 arm clamps: no segment is degenerate
    segs = shape_fit.plus_segments(torch.tensor([0.1, 0.1, 5.0, 5.0, 0.0, 0.0, 0.0, 0.0, 0.3])).numpy()
    assert segs.shape == (12, 2, 2) and (np.linalg.norm(segs[:, 1] - segs[:, 0], axis=1) > 1e-6).all()


@pytest.mark.parametrize("family", ["plus", "lens"])
def test_shape_fits_match_hint_tpu(family, tmp_path):
    """The batched fit of 8 clean curves: every restart's final loss and the
    chosen parameters of each curve against hint_tpu's vmapped scan."""
    model_cls = fourier.PlusShapeModel if family == "plus" else fourier.LensShapeModel
    curves = _clean_curves(model_cls, 8, seed=5)
    if family == "plus":
        angles = shape_fit.dominant_angles_ransac_batch(curves)
        ours, theirs = shape_fit._fit_plus_restarts, jax_fit._fit_plus_restarts
        batch, jax_batch = shape_fit.fit_plus_shapes_batch, jax_fit.fit_plus_shapes_batch
    else:
        angles = np.array([shape_fit.dominant_angle_lens(c) for c in curves], np.float32)
        ours, theirs = shape_fit._fit_lens_restarts, jax_fit._fit_lens_restarts
        batch, jax_batch = shape_fit.fit_lens_shapes_batch, jax_fit.fit_lens_shapes_batch
    params, losses = ours(torch.from_numpy(curves), torch.from_numpy(angles))
    ref_params, ref_losses = jax.vmap(theirs)(jnp.asarray(curves), jnp.asarray(angles))
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(params.numpy(), np.asarray(ref_params), rtol=0, atol=FIT_TOL)
    chosen = batch(curves, device="cpu")
    np.testing.assert_allclose(chosen, jax_batch(curves), rtol=0, atol=FIT_TOL)
    outlines = (shape_fit.plus_outlines_batch if family == "plus" else shape_fit.lens_outlines_batch)(
        chosen, device="cpu")
    iou, dice = shape_fit.iou_and_dice_batch(outlines, curves, chunk=3, device="cpu")
    ref_iou, ref_dice = jax_fit.iou_and_dice_batch(outlines, curves, chunk=8)
    np.testing.assert_allclose(iou, ref_iou, rtol=0, atol=5e-3)
    np.testing.assert_allclose(dice, ref_dice, rtol=0, atol=5e-3)
    assert iou.min() > (0.9 if family == "plus" else 0.85)  # clean shapes fit
    with one_rank_mesh(tmp_path) as mesh:  # the sharded path over one rank
        np.testing.assert_array_equal(batch(curves, mesh=mesh), chosen)
        np.testing.assert_array_equal(
            np.stack(shape_fit.iou_and_dice_batch(outlines, curves, chunk=3, mesh=mesh)), np.stack([iou, dice]))


def _per_pixel_inside(px, py, poly):
    """The even-odd test of every pixel against every edge, as
    ``shape_fit`` computed it before its row-wise form."""
    x0, y0 = poly[..., 0], poly[..., 1]
    x1, y1 = torch.roll(x0, -1, dims=-1), torch.roll(y0, -1, dims=-1)
    cnt = torch.zeros(px.shape, dtype=torch.int32)
    for i in range(poly.shape[1]):
        a0, b0, a1, b1 = x0[:, i, None], y0[:, i, None], x1[:, i, None], y1[:, i, None]
        cond = (b0 <= py) != (b1 <= py)
        cnt += cond & (px < a0 + (py - b0) * (a1 - a0) / (b1 - b0))
    return cnt % 2 == 1


@pytest.mark.parametrize("family", ["lens", "plus"])
def test_row_wise_raster_equals_the_per_pixel_test(family):
    """The rasters of the IoU/DICE scores count each row's edge crossings
    once and search them per pixel: the same inside decisions, bit for bit,
    on traced prior curves, some with vertices on pixel rows and columns."""
    model = fourier.LensShapeModel() if family == "lens" else fourier.PlusShapeModel()
    np.random.seed(4)
    curves = model.trace_fourier_curves(model.unflatten_coeffs(model.sample_prior(6))).astype(np.float32)
    curves[:3] = np.round(curves[:3] * 4) / 4  # vertices on grid lines: ties and horizontal edges
    poly = torch.from_numpy(curves)
    lo, hi = poly.amin(1) - 0.25, poly.amax(1) + 0.25
    xs, ys = shape_fit._linspace(lo[:, 0], hi[:, 0], 81), shape_fit._linspace(lo[:, 1], hi[:, 1], 81)
    px = xs[:, None, :].expand(-1, 81, -1).reshape(6, -1)
    py = ys[:, :, None].expand(-1, -1, 81).reshape(6, -1)
    got = shape_fit._even_odd_inside(xs, ys, poly)
    ref = _per_pixel_inside(px, py, poly)
    assert ref.any() and not ref.all()
    assert torch.equal(got, ref)


def test_shape_fit_self_checks_on_cpu(capsys):
    np.random.seed(1)
    iou, dice, mh, ah = shape_fit.check_plus_shape_fitting(device="cpu")
    assert iou > 0.9 and dice > 0.9 and ah < 0.1
    np.random.seed(2)
    iou, dice, mh, ah = shape_fit.check_lens_shape_fitting(device="cpu")
    assert iou > 0.85 and dice > 0.9
    assert capsys.readouterr().out.count("IoU:") == 2


# -- drivers and the experiment subcommand ---------------------------------------------------------


def test_eval_shapes_and_collect_uci_match_hint_tpu(tmp_path, capsys):
    """The same results files scored by both packages: ``eval-shapes`` on
    saved plus samples and ``collect-uci`` on saved UCI loss arrays."""
    config, uci = "plus_shape.unconditional_hint_4_full", ("uci_data.power_hint_4", "uci_data.miniboone_hint_8")
    np.random.seed(6)
    model = fourier.PlusShapeModel()
    coeffs = model.unflatten_coeffs(model.sample_joint(6)[0])
    coeffs[5] = np.nan  # a diverged sample is dropped by both
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        np.save(tmp_path / side / "plus_shape-unconditional_hint_4_full_0_sample.npy", coeffs)
        for i, name in enumerate(uci):
            np.save(tmp_path / side / f"{name.replace('.', '-')}.npy", np.array([1.5 + i, -2.25 * i, 0.125]))
    cli.main(["experiment", "eval-shapes", config, "--results-dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_experiments.eval_shapes([config], results_dir=str(tmp_path / "jax"))
    got = np.load(tmp_path / "port" / "plus_shape-unconditional_hint_4_full_0.npy")
    ref = np.load(tmp_path / "jax" / "plus_shape-unconditional_hint_4_full_0.npy")
    assert got.shape == (4,) and np.isfinite(got).all() and got[0] > 0.9
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_TOL)
    out = cli.main(["experiment", "collect-uci", *uci, "--results-dir", str(tmp_path / "port")])
    assert out == jax_experiments.uci_collect_results(uci, results_dir=str(tmp_path / "jax"))
    text = capsys.readouterr().out
    assert "dropped 1/6" in text and "uci_data.miniboone_hint_8" in text
    np.save(tmp_path / "port" / "plus_shape-unconditional_hint_4_full_1.npy", got)
    means, stds = cli.main(["experiment", "collect-shapes", config, "--runs", "2",
                            "--results-dir", str(tmp_path / "port")])[config]
    np.testing.assert_allclose(means, got)
    np.testing.assert_allclose(stds, 0.0, atol=1e-12)


def _help(main, argv, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    return capsys.readouterr().out


def test_experiment_parser_matches_hint_tpus(capsys):
    ours = _help(cli.main, ["experiment", "--help"], capsys)
    theirs = _help(jax_cli.main, ["experiment", "--help"], capsys)
    choices = "{shapes,uci,collect-uci,collect-shapes,eval-shapes,likelihood}"
    assert choices in ours and choices in theirs

    def options(text):
        return {w.rstrip(",") for w in text.split() if w.startswith("--")}

    assert options(ours) - options(theirs) == {"--dtype", "--impl", "--device"}
    assert options(theirs) <= options(ours)
    args = cli.parser().parse_args(["experiment", "uci"])
    assert (args.configs, args.runs, args.results_dir, args.uci_root, args.impl, args.device) == (
        [], 1, "results", ".", "levelwise", "cuda")
    assert experiments.UCI_CONFIGS == jax_experiments.drivers.UCI_CONFIGS
