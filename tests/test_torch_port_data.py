"""The port's toy-data modules against the JAX package's: with the same
``np.random.seed`` the generators and every public geometry function return
equal arrays (they are copies of numpy-only code), and ``prepare_toy_data``
writes and re-reads its cache, from the numpy or the native generator."""

import numpy as np
import pytest
import torch

from hint_tpu.data import fourier as jax_fourier
from hint_tpu.data import geometry as jax_geo
from hint_tpu_torch.configs import get_config
from hint_tpu_torch.data import fourier, geometry, loaders, native


@pytest.mark.parametrize("name", ["PlusShapeModel", "LensShapeModel"])
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_joint_equals_jax_package(name, seed):
    ours, theirs = getattr(fourier, name)(), getattr(jax_fourier, name)()
    assert (ours.name, ours.n_parameters, ours.n_observations) == (
        theirs.name, theirs.n_parameters, theirs.n_observations)
    np.random.seed(seed)
    x, y = ours.sample_joint(6)
    np.random.seed(seed)
    xr, yr = theirs.sample_joint(6)
    assert x.shape == (6, ours.n_parameters) and y.shape == (6, ours.n_observations)
    np.testing.assert_array_equal(x, xr)
    np.testing.assert_array_equal(y, yr)
    np.random.seed(seed)
    prior = ours.sample_prior(3)
    np.random.seed(seed)
    np.testing.assert_array_equal(prior, theirs.sample_prior(3))
    np.testing.assert_array_equal(
        ours.trace_fourier_curves(ours.unflatten_coeffs(x)), theirs.trace_fourier_curves(theirs.unflatten_coeffs(xr)))
    np.random.seed(seed)
    fp = ours.forward_process(x)
    np.random.seed(seed)
    np.testing.assert_array_equal(fp, theirs.forward_process(xr))


def test_geometry_functions_equal_jax_package():
    rng = np.random.default_rng(0)
    c0, c1 = geometry.circle_polygon(0.0, 0.0, 1.3), geometry.circle_polygon(0.9, 0.4, 1.1, resolution=8)
    np.testing.assert_array_equal(c0, jax_geo.circle_polygon(0.0, 0.0, 1.3))
    assert geometry.polygon_area(c0) == jax_geo.polygon_area(c0) > 0
    np.testing.assert_array_equal(geometry.ensure_ccw(c0[::-1]), jax_geo.ensure_ccw(c0[::-1]))
    lens = geometry.convex_intersection(c0, c1)
    np.testing.assert_array_equal(lens, jax_geo.convex_intersection(c0, c1))
    assert 0 < geometry.polygon_area(lens) < geometry.polygon_area(c1)
    assert geometry.convex_intersection(c0, c1 + 10.0).shape == (0, 2)
    bars = ((-2.0, -0.4), (2.0, 0.4)), ((-0.3, -1.5), (0.3, 2.5))
    plus = geometry.rect_union_outline(*bars)
    np.testing.assert_array_equal(plus, jax_geo.rect_union_outline(*bars))
    assert len(plus) == 12
    pts = rng.uniform(-3, 3, size=(200, 2))
    inside = geometry.points_in_polygon(pts, plus)
    np.testing.assert_array_equal(inside, jax_geo.points_in_polygon(pts, plus))
    assert 0 < inside.sum() < 200
    assert geometry.iou_and_dice(c0, c1, resolution=64) == jax_geo.iou_and_dice(c0, c1, resolution=64)
    assert geometry.hausdorff(c0, c1) == jax_geo.hausdorff(c0, c1)


def test_prepare_toy_data_writes_and_rereads_its_cache(tmp_path, capsys):
    model = fourier.LensShapeModel()
    cache = str(tmp_path / "cache")
    np.random.seed(0)
    (x_tr, y_tr), (x_te, y_te) = loaders.prepare_toy_data(model, 12, 5, cache)
    assert "generating 12 new samples" in capsys.readouterr().out
    assert x_tr.shape == (12, 20) and y_tr.shape == (12, 2) and x_te.shape == (5, 20)
    assert x_tr.dtype == y_te.dtype == np.float32
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "lens-shape1_x_test.npy", "lens-shape1_x_train.npy", "lens-shape1_y_test.npy", "lens-shape1_y_train.npy"]
    (x2, y2), _ = loaders.prepare_toy_data(model, 8, 5, cache)  # a prefix of the cache, nothing generated
    assert capsys.readouterr().out == ""
    np.testing.assert_array_equal(x2, x_tr[:8])
    np.testing.assert_array_equal(y2, y_tr[:8])
    loaders.prepare_toy_data(model, 14, 5, cache)  # cache too short: regenerated
    assert "generating 14 new samples" in capsys.readouterr().out
    native_cache = str(tmp_path / "native")  # the native generator: train stream 0, test stream 1
    (xn, yn), (xnt, _) = loaders.prepare_toy_data(model, 6, 3, native_cache, engine="native")
    np.testing.assert_array_equal(xn, native.sample_joint(model.name, 6, seed=0)[0])
    np.testing.assert_array_equal(xnt, native.sample_joint(model.name, 3, seed=1)[0])
    with pytest.raises(ValueError, match="unknown engine"):
        loaders.prepare_toy_data(model, 4, 4, cache, engine="tpu")
    xd, yd = loaders.to_device((x_tr, None), "cpu")
    assert isinstance(xd, torch.Tensor) and yd is None and xd.shape == (12, 20)


def test_config_data_entry_points(tmp_path):
    cfg = get_config("lens_shape.unconditional_hint_1_full")
    assert (cfg.kind, cfg.ndim_z, cfg.is_uci, cfg.suffix) == (
        "unconditional", 20, False, "lens-shape1_unconditional-hint-1-full")
    assert isinstance(cfg.data_model(), fourier.LensShapeModel)
    assert isinstance(get_config("plus_shape.unconditional_hint_4_full").data_model(), fourier.PlusShapeModel)
    with pytest.raises(FileNotFoundError, match="uci_data/power/data.npy"):  # read from the UCI root
        get_config("uci_data.power_hint_4").load_data(str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match="fourier-curve"):
        get_config("plus_shape.conditional_cinn_1").load_data(str(tmp_path))
