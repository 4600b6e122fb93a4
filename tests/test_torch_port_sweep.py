"""The port's device prior sweeps (``hint_tpu_torch.data.{lens,plus}_tpu``)
against the JAX package's, on the CPU: the same seeded numpy draws go
through ``hint_tpu``'s jitted functions and through the port's with
``device="cpu"``. Also ``prepare_samples(engine="tpu")``, its provenance
tag, and ``utils``.

Tolerances, each with its reason (both sides are f32; the bounds of
``tests/test_lens_tpu.py`` and ``tests/test_plus_tpu.py`` against the f64
host are upper limits):

* integers (ring lengths ``k``, ``V``, ``N``, the winning pair's ``i1``, the
  band, seam, bad and plus flags): equal on every row that neither side
  flags;
* lens rings, x from the same rings, the trace and the screen's
  features: 1e-5 absolute (values up to ~6, a few f32 roundings apart per
  operation: other sin/cos, other summation orders; measured <= 2.3e-6);
  x end to end from the same draws: 5e-5;
* plus rings and densified polylines: 2e-6 (linear interpolation between
  the same f32 vertices, measured 2.4e-7); the plus pipeline's packed
  values: 5e-5 (measured 4.2e-7);
* the host fix-ups (f64 numpy on both sides) and ``_unpack_x``:
  bit-identical;
* the distribution against the host numpy engine: a two-sample KS test per
  dimension with the critical value of ``tests/test_lens_tpu.py``,
  1.95 sqrt(2/n) (alpha ~1e-3 a dimension by the asymptotic formula).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.data import fourier as jax_fourier
from hint_tpu.data import lens_tpu as jax_lens
from hint_tpu.data import plus_tpu as jax_plus
from hint_tpu.evaluation import abc as jax_abc
from hint_tpu_torch import cli
from hint_tpu_torch.data import fourier, lens_tpu, plus_tpu
from hint_tpu_torch.evaluation import abc
from hint_tpu_torch.utils import profile_trace

TOL = 1e-5
CPU = torch.device("cpu")
FAMILIES = {"lens": (lens_tpu, fourier.LensShapeModel, 20, 2), "plus": (plus_tpu, fourier.PlusShapeModel, 100, 4)}


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(*tensors):
    return [np.asarray(t) for t in tensors]


# -- lens ------------------------------------------------------------------------------------


def _lens_draws(seed, n):
    rng = np.random.RandomState(seed)
    r0 = (1.0 + rng.rand(n)).astype(np.float32)
    theta = (2 * np.pi * rng.rand(n)).astype(np.float32)
    shift = rng.randn(n, 2).astype(np.float32)
    return r0, theta, shift


def test_lens_rings_and_x_match_hint_tpu():
    r0, theta, shift = _lens_draws(7, 256)
    jx, jy, jk = _np(*jax.jit(jax_lens._lens_rings_xy)(jnp.asarray(r0), jnp.asarray(theta)))
    px, py, k = _np(*lens_tpu._lens_rings_xy(_t(r0), _t(theta)))
    live = (jk > 0) & (k > 0)
    assert live.sum() >= 250
    np.testing.assert_array_equal(k[live], jk[live])
    assert (k <= lens_tpu.P).all() and not jx[:, lens_tpu.P :].any()  # the port's 80 slots hold every ring
    for a, b in ((px, jx), (py, jy)):
        np.testing.assert_allclose(a[live], b[live, : lens_tpu.P], atol=TOL, rtol=0)
        assert not a[live][np.arange(lens_tpu.P)[None] >= k[live][:, None]].any()  # zeros past k
    # x from the same rings: the DFT alone
    jxx = np.asarray(jax.jit(jax_lens._ring_to_x_xy)(jnp.asarray(jx), jnp.asarray(jy), jnp.asarray(jk),
                                                     jnp.asarray(shift)))
    xx = lens_tpu._ring_to_x_xy(_t(jx), _t(jy), _t(jk).long(), _t(shift)).numpy()
    np.testing.assert_allclose(xx[live], jxx[live], atol=TOL, rtol=0)
    # x end to end from the same draws
    xe = lens_tpu._ring_to_x_xy(*lens_tpu._lens_rings_xy(_t(r0), _t(theta)), _t(shift)).numpy()
    np.testing.assert_allclose(xe[live], jxx[live], atol=5e-5, rtol=0)


def test_lens_rings_stay_within_the_ports_capacity(monkeypatch):
    """The port holds a ring in 80 slots, not hint_tpu's 128: at the lens
    geometry no clip pass over 20,000 draws takes a ring past its first 64
    vertices, and a pass that would overflow marks its row bad."""
    seen = []
    inner = lens_tpu._clip_edge

    def clip(pts, k, a, e, tol):
        pts, k = inner(pts, k, a, e, tol)
        seen.append(int(k.max()))
        return pts, k

    monkeypatch.setattr(lens_tpu, "_clip_edge", clip)
    r0, theta, _ = _lens_draws(17, 20_000)
    _, _, k = lens_tpu._lens_rings_xy(_t(r0), _t(theta))
    assert len(seen) == lens_tpu.N_CIRCLE and max(seen) <= lens_tpu.N_CIRCLE < lens_tpu.P
    assert (k > 0).all()


def test_lens_trace_and_screen_match_hint_tpu():
    np.random.seed(11)
    x = fourier.LensShapeModel().sample_prior(512).astype(np.float32)
    jt = _np(*jax.jit(jax_lens._trace_xy)(jnp.asarray(x)))
    tt = _np(*lens_tpu._trace_xy(_t(x)))
    for a, b in zip(tt, jt):
        assert a.shape == (512, lens_tpu.N_TRACE)
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    jf, jband, jseam, ji1 = _np(*jax.jit(jax_lens._forward_screen)(jnp.asarray(x)))
    f, band, seam, i1 = _np(*lens_tpu._forward_screen(_t(x)))
    np.testing.assert_array_equal(band, jband)
    clear = ~band & ~jband
    np.testing.assert_array_equal(seam[clear], jseam[clear])
    np.testing.assert_array_equal(i1[clear], ji1[clear])
    np.testing.assert_allclose(f[clear], jf[clear], atol=TOL, rtol=0)
    assert seam[clear].any() and (~seam[clear]).any()


def test_lens_screen_plus_host_fixes_equal_the_host_forward_process():
    """Device screen + the host's refine and seam fixes = the host forward
    process (noise 0), as hint_tpu's ``test_forward_parity`` holds its own."""
    model = fourier.LensShapeModel()
    np.random.seed(11)
    x = model.sample_prior(96).astype(np.float32)
    np.random.seed(0)
    ref = model.forward_process(x.copy(), noise=0.0)
    feats, band, seam, i1 = _np(*lens_tpu._forward_screen(_t(x)))
    feats = feats.astype(np.float64)
    if band.any():
        feats[band] = lens_tpu._refine_host(x[band])
    seam_only = seam & ~band
    if seam_only.any():
        feats[seam_only] = lens_tpu._seam_host(x[seam_only], i1[seam_only])
    np.testing.assert_allclose(feats, ref, atol=2e-4, rtol=0)


def test_screen_flags_an_exact_top_tie_into_the_band(monkeypatch):
    """Two pairs with exactly equal top d^2 (25 = 3^2 + 4^2 = 5^2 + 0^2):
    whatever order ``torch.topk`` gives them, the row goes to the host."""
    tx = torch.full((2, lens_tpu.N_TRACE), 2.5)  # the other points at (2.5, 1)
    ty = torch.full((2, lens_tpu.N_TRACE), 1.0)
    tx[:, 0], ty[:, 0] = 0.0, 0.0
    tx[:, 10], ty[:, 10] = 3.0, 4.0  # d^2(0, 10) = 25
    tx[:, 20], ty[:, 20] = 5.0, 0.0  # d^2(0, 20) = 25, d^2(10, 20) = 20
    tx[1, 20] = 4.0  # row 1: one winner, 25 against 17
    monkeypatch.setattr(lens_tpu, "_trace_xy", lambda x: (tx, ty))
    _, band, seam, i1 = lens_tpu._forward_screen(torch.zeros(2, 20))
    assert band.tolist() == [True, False]
    assert seam[1] and i1[1] == 10


def test_run_ends_are_the_first_entry_and_exit():
    """The int8 code's argmax and argmin are the first True slots of
    hint_tpu's ``cross & inside`` and ``cross & ~inside`` (PyTorch returns
    the first of tied extremes), on rings with one run, several runs (c > 2)
    and none."""
    rng = np.random.default_rng(3)
    P = lens_tpu.P
    k = rng.integers(0, P + 1, size=256)
    valid = np.arange(P)[None] < k[:, None]
    inside = (rng.random((256, P)) < rng.random((256, 1))) & valid
    inside[:64] = valid[:64] & ((np.arange(P)[None] + rng.integers(0, P, (64, 1))) % P < P // 2)  # one run
    inside[64:72] = valid[64:72]  # all kept
    inside[72:80] = False  # all cut
    prev = np.array([np.roll(row[:n], 1).tolist() + [False] * (P - n) for row, n in zip(inside, k)], bool)
    s, x, c = (t.numpy() for t in lens_tpu._run_ends(torch.as_tensor(inside), torch.as_tensor(prev)))
    cross = inside != prev
    np.testing.assert_array_equal(s, np.argmax(cross & inside, axis=1))
    np.testing.assert_array_equal(x, np.argmax(cross & ~inside & valid, axis=1))
    np.testing.assert_array_equal(c, cross.sum(1))
    assert (c[:64] <= 2).all() and (c[64:80] == 0).all() and (c > 2).any()


def test_near_parallel_crossing_marks_the_row_bad():
    """The triangle (-1, -1e-8), (1, 1e-8), (0, 1) clipped by the x-axis: its
    first edge crosses the clip line with a slope of 1e-8, so its crossing
    point rests on a division by a denominator at the level of rounding.
    ``hint_tpu`` keeps the row; the port marks it bad for the host's f64
    redraw."""
    px = np.zeros((1, jax_lens.P), np.float32)
    py = np.zeros((1, jax_lens.P), np.float32)
    px[0, :3], py[0, :3] = [-1.0, 1.0, 0.0], [-1e-8, 1e-8, 1.0]
    k = np.array([3], np.int32)
    edge = [np.array([v], np.float32) for v in (-10.0, 0.0, 10.0, 0.0)]
    (_, _, jk), _ = jax.jit(jax_lens._clip_edge)((jnp.asarray(px), jnp.asarray(py), jnp.asarray(k)),
                                                 tuple(jnp.asarray(e) for e in edge))
    assert int(jk[0]) == 4  # hint_tpu: a regular pass, not flagged
    pts = torch.stack([_t(px[:, : lens_tpu.P]), _t(py[:, : lens_tpu.P])], dim=1)

    def clip(ax, ay, bx, by):
        a, e = torch.tensor([[ax, ay]]), torch.tensor([[bx - ax, by - ay]])
        return lens_tpu._clip_edge(pts, _t(k).long(), a, e, lens_tpu.DENOM_EPS * e.abs().sum(1))

    out, kt = clip(-10.0, 0.0, 10.0, 0.0)
    assert int(kt[0]) == 0 and not out.any()
    # the same triangle clipped by a steep line: a regular pass, as hint_tpu's
    steep = [np.array([v], np.float32) for v in (0.5, -10.0, 0.5, 10.0)]
    (jpx, jpy, jk), _ = jax.jit(jax_lens._clip_edge)((jnp.asarray(px), jnp.asarray(py), jnp.asarray(k)),
                                                     tuple(jnp.asarray(e) for e in steep))
    out, ks = clip(*(float(v[0]) for v in steep))
    assert int(ks[0]) == int(jk[0]) == 4
    np.testing.assert_allclose(out[0].numpy(), np.stack([jpx, jpy], axis=1)[0, :, : lens_tpu.P], atol=TOL, rtol=0)


def test_lens_host_fixups_are_hint_tpus(monkeypatch):
    model = fourier.LensShapeModel()
    np.random.seed(29)
    x = model.sample_prior(64).astype(np.float32)
    np.testing.assert_array_equal(lens_tpu._refine_host(x), jax_lens._refine_host(x))
    monkeypatch.setattr(lens_tpu, "REFINE_ROWS", 7)  # the refine's row blocks, one of them ragged
    np.testing.assert_array_equal(lens_tpu._refine_host(x), jax_lens._refine_host(x))
    i1 = np.random.RandomState(1).randint(1, 99, size=64)
    np.testing.assert_array_equal(lens_tpu._seam_host(x, i1), jax_lens._seam_host(x, i1))
    # the seam ulp-tie row of tests/test_lens_tpu.py: d(38, 99) and d(0, 38)
    # round equal, so the reference keeps (0, 38)
    tie = np.array([[
        0.09095285087823868, 0.4457179307937622, -0.22821182012557983, 0.4457179307937622,
        0.09095285087823868, 0.05451823025941849, 0.5210657715797424, 0.6912301182746887,
        0.5210657715797424, 0.05451823025941849, 0.10121825337409973, -0.37077128887176514,
        0.0, 0.37077128887176514, -0.10121825337409973, 0.08546189963817596,
        0.03648364916443825, 0.0, -0.03648364916443825, -0.08546189963817596,
    ]], dtype=np.float32)
    got = lens_tpu._seam_host(tie, np.array([38]))
    np.testing.assert_array_equal(got, jax_lens._seam_host(tie, np.array([38])))
    np.testing.assert_array_equal(got, lens_tpu._refine_host(tie))
    r0, theta, shift = _lens_draws(5, 6)
    for a, b in zip(lens_tpu._regen_host(r0, theta, shift), jax_lens._regen_host(r0, theta, shift)):
        np.testing.assert_array_equal(a, b)


# -- plus ------------------------------------------------------------------------------------


def _plus_draws(seed, n):
    rng = np.random.RandomState(seed)
    xl = (3 + 2 * rng.rand(n)).astype(np.float32)
    yl = (3 + 2 * rng.rand(n)).astype(np.float32)
    xw = (0.5 + 1.5 * rng.rand(n)).astype(np.float32)
    yw = (0.5 + 1.5 * rng.rand(n)).astype(np.float32)
    xs = (-1.5 + 3 * rng.rand(n)).astype(np.float32)
    ys = (-1.5 + 3 * rng.rand(n)).astype(np.float32)
    angle = (0.5 * np.pi * rng.rand(n)).astype(np.float32)
    off = (0.5 * rng.randn(n, 2)).astype(np.float32)
    return xl, yl, xw, yw, xs, ys, angle, off


def _bars(d):
    xl, yl, xw, yw, xs, ys = d[:6]
    return (xs - xl / 2, xs + xl / 2, -xw / 2, xw / 2, -yw / 2, yw / 2, ys - yl / 2, ys + yl / 2)


def test_plus_ring_and_densify_match_hint_tpu():
    bars = _bars(_plus_draws(7, 256))
    jr = _np(*jax.jit(jax_plus._union_ring)(*(jnp.asarray(b) for b in bars)))
    rx, ry, V, margin = _np(*plus_tpu._union_ring(*(_t(b) for b in bars)))
    np.testing.assert_array_equal(V, jr[2])
    for a, b in ((rx, jr[0]), (ry, jr[1]), (margin, jr[3])):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
    jd = _np(*jax.jit(jax_plus._densify)(*(jnp.asarray(a) for a in jr[:3])))
    px, py, N, round_margin = _np(*plus_tpu._densify(_t(jr[0]), _t(jr[1]), _t(jr[2]).long()))
    np.testing.assert_array_equal(N, jd[2])
    for a, b in ((px, jd[0]), (py, jd[1]), (round_margin, jd[3])):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


def test_plus_pipeline_matches_hint_tpu():
    d = _plus_draws(3, 256)
    jp, jparams = _np(*jax.jit(jax_plus._pipeline)(*(jnp.asarray(a) for a in d)))
    packed, params = _np(*plus_tpu._pipeline(*(_t(a) for a in d)))
    assert packed.shape == (256, plus_tpu.N_PACK) and plus_tpu.FLAG_COLUMN == plus_tpu.N_PACK - 1
    np.testing.assert_array_equal(params, jparams)
    np.testing.assert_array_equal(packed[:, plus_tpu.FLAG_COLUMN], jp[:, jax_plus.N_PACK - 1])
    clear = packed[:, plus_tpu.FLAG_COLUMN] == 0
    np.testing.assert_allclose(packed[clear], jp[clear], atol=5e-5, rtol=0)
    # against the host's f64 replay of the same draws, after the mirror
    x_ref, y_ref = plus_tpu._regen_host(params)
    np.testing.assert_allclose(plus_tpu._unpack_x(packed[:, :50].astype(np.float64)), x_ref, atol=5e-5, rtol=0)
    np.testing.assert_allclose(packed[:, 50:54], y_ref, atol=5e-5, rtol=0)


def test_plus_host_fixups_are_hint_tpus():
    packed = np.random.default_rng(4).standard_normal((32, 50)).astype(np.float32)
    x = plus_tpu._unpack_x(packed)
    np.testing.assert_array_equal(x, jax_plus._unpack_x(packed))
    n = plus_tpu.N_COEFFS
    np.testing.assert_array_equal(x[:, 2 * n + plus_tpu.M_MAX], 0.0)  # Im(0) of x
    np.testing.assert_array_equal(x[:, :plus_tpu.M_MAX], x[:, 2 * plus_tpu.M_MAX : plus_tpu.M_MAX : -1])
    d = _plus_draws(5, 6)
    params = np.concatenate([np.stack(d[:7], axis=1), d[7]], axis=1)
    for a, b in zip(plus_tpu._regen_host(params), jax_plus._regen_host(params)):
        np.testing.assert_array_equal(a, b)


# -- the sweep -------------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sample_joint_is_deterministic_and_a_prefix_for_every_group(family):
    mod, _, dx, dy = FAMILIES[family]
    x, y = mod.sample_joint(700, seed=5, sub_batch=128, group=3, device="cpu")
    assert x.shape == (700, dx) and y.shape == (700, dy) and x.dtype == y.dtype == np.float32
    assert np.isfinite(x).all() and np.isfinite(y).all()
    for group in (1, 2, 8):
        xs, ys = mod.sample_joint(300, seed=5, sub_batch=128, group=group, device="cpu")
        np.testing.assert_array_equal(xs, x[:300])
        np.testing.assert_array_equal(ys, y[:300])
    x2, _ = mod.sample_joint(300, seed=6, sub_batch=128, device="cpu")
    assert not np.array_equal(x2, x[:300])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sample_joint_needs_a_card_unless_told_otherwise(family, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FAMILIES[family][0].sample_joint(4, sub_batch=4)


def _ks(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return np.abs(np.searchsorted(a, grid, side="right") / len(a)
                  - np.searchsorted(b, grid, side="right") / len(b)).max()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_distribution_matches_the_host_engine(family):
    """Two-sample KS per x and per y dimension between the port's sweep
    and the host numpy engine: the same prior, the same forward process."""
    mod, model_cls, dx, dy = FAMILIES[family]
    n = 1500
    xt, yt = mod.sample_joint(n, seed=123, sub_batch=512, device="cpu")
    np.random.seed(321)
    xh, yh = model_cls().sample_joint(n)
    crit = 1.95 * np.sqrt(2.0 / n)  # tests/test_lens_tpu.py's, n = m
    for d in range(dx):
        assert _ks(xt[:, d], xh[:, d]) < crit, f"x dim {d}"
    for d in range(dy):
        assert _ks(yt[:, d], yh[:, d]) < crit, f"y dim {d}"


def test_flags_are_read_from_each_engines_column():
    """lens's flag is column 24 of 26, plus's column 54 of 55; a dispatch's
    flagged rows are the ones the host redraws."""
    assert (lens_tpu.FLAG_COLUMN, lens_tpu.N_PACK) == (24, 26) == (24, jax_lens.N_PACK)
    assert (plus_tpu.FLAG_COLUMN, plus_tpu.N_PACK) == (54, 55) == (54, jax_plus.N_PACK)
    gen = torch.Generator().manual_seed(0)
    packed, (params,) = plus_tpu._sub_batch(gen, 64, CPU)
    packed = packed.numpy().copy()
    packed[3, plus_tpu.FLAG_COLUMN] = 1.0  # the host redraws row 3 from its draws
    x, y = plus_tpu._host_finish(packed, lambda: [params.numpy()])
    x_ref, y_ref = plus_tpu._regen_host(params.numpy()[3:4])
    np.testing.assert_array_equal(x[3], x_ref[0])
    np.testing.assert_array_equal(y[3], y_ref[0])
    np.testing.assert_array_equal(x[4], plus_tpu._unpack_x(packed[4:5, :50])[0])


# -- prepare_samples(engine="tpu") -----------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prepare_samples_tpu_engine_builds_and_reuses_its_pool(family, tmp_path):
    _, model_cls, dx, dy = FAMILIES[family]
    kw = dict(n_total=600, out_dir=str(tmp_path), chunk=200, engine="tpu", sub_batch=128, device="cpu")
    x, y = abc.prepare_samples(model_cls, **kw)
    assert x.shape == (600, dx) and y.shape == (600, dy)
    assert np.isfinite(np.asarray(x)).all() and np.isfinite(np.asarray(y)).all()
    name = model_cls().name
    assert sorted(os.listdir(tmp_path)) == [f"{name}_x_huge.npy", f"{name}_y_huge.npy"]
    # chunk i is the sweep of seed ABC_SEED_OFFSET + i
    xc, _ = FAMILIES[family][0].sample_joint(200, seed=abc.ABC_SEED_OFFSET + 2, sub_batch=128, device="cpu")
    np.testing.assert_array_equal(np.asarray(x[400:]), xc)
    x2, y2 = abc.prepare_samples(model_cls, **kw)
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(y2), np.asarray(y))


def test_prepare_samples_tpu_engine_resumes_its_own_pool_and_no_other(tmp_path, monkeypatch):
    """An interrupted device pool resumes to the pool built in one go; its
    header says ``tpu-torch``, so hint_tpu's ``tpu`` engine (threefry)
    refuses it, and the port refuses a partial pool hint_tpu's started."""
    model = fourier.PlusShapeModel
    kw = dict(n_total=600, chunk=200, engine="tpu", sub_batch=128)
    whole, _ = abc.prepare_samples(model, out_dir=str(tmp_path / "whole"), device="cpu", **kw)
    calls = []
    inner = abc._sample_chunk

    def interrupted(args):
        calls.append(args)
        if len(calls) == 3:  # the probe, chunk 0, then chunk 1 fails
            raise KeyboardInterrupt
        return inner(args)

    part = str(tmp_path / "part")
    monkeypatch.setattr(abc, "_sample_chunk", interrupted)
    with pytest.raises(KeyboardInterrupt):
        abc.prepare_samples(model, out_dir=part, device="cpu", **kw)
    monkeypatch.setattr(abc, "_sample_chunk", inner)
    prog = os.path.join(part, "plus-shape_x_huge.npy.progress")
    with open(prog) as f:
        assert f.read().split() == ["600", "200", "0", "tpu-torch", "0"]
    with pytest.raises(RuntimeError, match="refusing to resume with engine='tpu'"):
        jax_abc.prepare_samples(jax_fourier.PlusShapeModel, out_dir=part, **kw)
    resumed, _ = abc.prepare_samples(model, out_dir=part, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(resumed), np.asarray(whole))
    # a partial pool hint_tpu's engine started
    theirs = str(tmp_path / "theirs")
    os.makedirs(theirs)
    for side in ("x", "y"):
        np.lib.format.open_memmap(os.path.join(theirs, f"plus-shape_{side}_huge.npy.building"), mode="w+",
                                  dtype=np.float32, shape=(600, 100 if side == "x" else 4))
    with open(os.path.join(theirs, "plus-shape_x_huge.npy.progress"), "w") as f:
        f.write("600 200 0 tpu\n0\n")
    with pytest.raises(RuntimeError, match="built with engine='tpu', refusing to resume with engine='tpu-torch'"):
        abc.prepare_samples(model, out_dir=theirs, device="cpu", **kw)


def test_prepare_samples_tpu_engine_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        abc.prepare_samples(fourier.LensShapeModel, n_total=10, out_dir=str(tmp_path), engine="tpu")
    assert not os.listdir(tmp_path)
    with pytest.raises(NotImplementedError, match="lens and plus"):
        abc.prepare_samples(_Other, n_total=10, chunk=10, out_dir=str(tmp_path), engine="tpu", sub_batch=16,
                            device="cpu")


class _Other(fourier.LensShapeModel):
    def __init__(self):
        super().__init__()
        self.name = "other-shape"


# -- utils -------------------------------------------------------------------------------------


def test_profile_trace_writes_a_trace_and_step_timer_counts(tmp_path):
    """The Chrome trace ``profile_trace`` writes holds the trainer's spans
    as they nest: each step of a capped epoch in the epoch, each of a
    step's parts in its step."""
    import json

    from hint_tpu_torch.configs import get_config

    trainer = get_config("lens_shape.unconditional_hint_1_full").make_trainer(device="cpu")
    trainer.batch_size, trainer.max_batches_per_epoch = 16, 3
    state = trainer.init_state(0)
    x = torch.randn((64, 20), generator=torch.Generator().manual_seed(0))
    with profile_trace(str(tmp_path / "trace")) as prof:
        trainer.train_epoch(state, x, None, torch.Generator().manual_seed(1), 0)
    (name,) = os.listdir(tmp_path / "trace")
    assert name.endswith(".json") and os.path.getsize(tmp_path / "trace" / name) > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        spans.setdefault(e["name"], []).append(e)

    def inside(child, parent):
        return all(any(p["tid"] == c["tid"] and p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]
                       for p in spans[parent]) for c in spans[child])

    assert len(spans["train.epoch"]) == 1 and len(spans["train.step"]) == 3
    for child in ("train.shuffle", "train.step", "train.read_losses"):
        assert inside(child, "train.epoch"), child
    for child in ("train.rows", "train.forward", "train.backward", "train.optimizer"):
        assert len(spans[child]) == 3 and inside(child, "train.step"), child


def test_train_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.main(["train", "--config", "lens_shape.unconditional_hint_1_full", "--device", "cpu", "--n-train", "32",
              "--n-test", "16", "--batch-size", "16", "--epochs", "1", "--profile-dir", "prof"])
    (name,) = os.listdir(tmp_path / "prof")
    assert name.endswith(".json")
