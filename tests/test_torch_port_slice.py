"""The port's serving slice against the JAX package: a 2-block ``hint``
Flow (d=100, narrow c_internal), checkpoints in both directions, the
inference service and its HTTP API (also for a condition-fed
``recursive_cinn`` and a two-lane ``conditional_hint``, with ``y`` and
``y_target``), the registry, and the port's isolation from JAX. Inputs and params are made with numpy / the JAX
package from seeds and fed to both sides; tolerance 1e-5."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.configs import get_config as jax_config
from hint_tpu.configs.registry_data import CONFIGS as JAX_CONFIGS
from hint_tpu.serve import InferenceService as JaxService
from hint_tpu.train import checkpoint as jax_ckpt
from hint_tpu_torch import cli
from hint_tpu_torch.configs import get_config, list_configs
from hint_tpu_torch.configs.registry_data import CONFIGS
from hint_tpu_torch.convert import load_params, params_from_numpy, params_to_numpy
from hint_tpu_torch.experiments import campaign
from hint_tpu_torch.serve import MAX_HTTP_SAMPLE_N, InferenceService, make_server
from hint_tpu_torch.train import checkpoint
from torch_parallel_world import one_rank_mesh

TOL = 1e-5
NAME = "plus_shape.unconditional_hint_4_full"
SHRINK = dict(n_blocks=2, c_internal=(16, 8))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _garbage_padding(params, flow, seed):
    """HAC weights halved (a random 2-block flow at full init scale is too
    ill-conditioned to compare inverses at 1e-5 in f32), then noise in every
    padded entry of every level stack."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, params)
    for key, b in zip(params, flow.bijectors):
        if not hasattr(b, "levels"):
            continue
        for li, lv in enumerate(b.levels):
            p, n = params[key][f"L{li}"], len(lv.nodes)
            for leaf in p.values():
                leaf *= 0.5
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                out_i = nd.dim - nd.split
                p["w0"][u, nd.split : lv.in_max] = rng.normal(size=p["w0"][u, nd.split : lv.in_max].shape)
                p["w2"][u, :, out_i:] = rng.normal(size=p["w2"][u, :, out_i:].shape)
                p["b2"][u, out_i:] = rng.normal(size=p["b2"][u, out_i:].shape)
    return params


@pytest.fixture(scope="module")
def jax_side():
    """(JAX config, JAX flow, params from its init with garbage padding)."""
    cfg = dataclasses.replace(jax_config(NAME), **SHRINK)
    flow = cfg.build_model()
    return cfg, flow, _garbage_padding(flow.init(jax.random.PRNGKey(0)), flow, 0)


@pytest.fixture(scope="module")
def port_cfg():
    return dataclasses.replace(get_config(NAME), **SHRINK)


@pytest.fixture(scope="module")
def jax_svc(jax_side):
    cfg, _, params = jax_side
    return JaxService(cfg, jax.tree.map(jnp.asarray, params), buckets=(4, 8))


@pytest.fixture(scope="module")
def svc(jax_side, port_cfg):
    return InferenceService(port_cfg, jax_side[2], buckets=(4, 8), device="cpu")


def _x(b, d=100, seed=0):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def test_flow_matches_jax(jax_side, port_cfg):
    _, jflow, params = jax_side
    flow = port_cfg.build_model(device="cpu")
    assert [type(b).__name__ for b in flow.bijectors] == [
        "HierarchicalAffineCoupling", "HouseholderPerm", "HierarchicalAffineCoupling",
    ]
    load_params(flow, params)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(37, seed=1)
    with torch.no_grad():
        for jf, tf in ((jflow.forward, flow.forward), (jflow.inverse, flow.inverse)):
            yj, ldj = jax.jit(jf)(jp, jnp.asarray(x))
            yt, ldt = tf(torch.from_numpy(x))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=TOL, atol=TOL)
        z, ld = flow(torch.from_numpy(x))
        x2, ld_inv = flow.inverse(z)
    zj, _ = jax.jit(jflow.forward)(jp, jnp.asarray(x))
    x2j, _ = jax.jit(jflow.inverse)(jp, zj)
    np.testing.assert_allclose(x2.numpy(), np.asarray(x2j), rtol=TOL, atol=TOL)
    # the round trip itself crosses 28 exp-scaled coupling levels in f32
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld_inv.numpy(), -ld.numpy(), rtol=TOL, atol=TOL)
    mask = flow.trainable_mask()
    assert mask["b1.q_fixed"] is False and mask["b0.L3.w1"] is True
    assert set(mask) == set(flow.state_dict())


def test_params_round_trip_through_numpy(jax_side, port_cfg):
    params = jax_side[2]
    flow = port_cfg.build_model(device="cpu")
    load_params(flow, params)
    back = params_to_numpy(flow)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    sd = params_from_numpy(params)
    assert sd["b0.L0.w0"].shape == params["b0"]["L0"]["w0"].shape


def test_jax_full_state_checkpoint_serves_in_port(tmp_path, jax_side, jax_svc, port_cfg):
    """A full training-state npz written by hint_tpu.train.checkpoint.save_npz
    serves from the port; its params[...] entries are read exactly."""
    from hint_tpu.train.optim import AdamState
    from hint_tpu.train.trainer import TrainState

    params = jax.tree.map(jnp.asarray, jax_side[2])
    zeros = jax.tree.map(jnp.zeros_like, params)
    state = TrainState(
        params=params, opt=AdamState(step=jnp.asarray(7), mu=zeros, nu=zeros), epoch=jnp.asarray(3)
    )
    path = str(tmp_path / "state.npz")
    jax_ckpt.save_npz(path, state)
    tree = checkpoint.load_params_npz(path)
    assert jax.tree.structure(tree) == jax.tree.structure(jax_side[2])
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jax_side[2])):
        np.testing.assert_array_equal(a, b)
    svc = InferenceService.from_checkpoint(port_cfg, path, buckets=(4, 8), device="cpu")
    x = _x(3, seed=2)
    np.testing.assert_allclose(svc.log_prob(x), jax_svc.log_prob(x), rtol=TOL, atol=TOL)


def test_checkpoints_move_both_ways(tmp_path, jax_side, port_cfg):
    _, jflow, params = jax_side
    jax_path = str(tmp_path / "jax_params.npz")
    jax_ckpt.save_params_npz(jax_path, jax.tree.map(jnp.asarray, params))
    tree = checkpoint.load_params_npz(jax_path)
    flow = port_cfg.build_model(device="cpu")
    load_params(flow, tree)
    port_path = str(tmp_path / "port_params.npz")
    checkpoint.save_params_npz(port_path, flow)
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params['b0']['L3']['w1']" in a.files
    back = jax_ckpt.load_params_npz(port_path, jax.tree.map(jnp.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_service_log_prob_matches_jax(jax_svc, svc):
    for n in (3, 8, 11):  # inside a bucket, a full bucket, beyond the largest
        x = _x(n, seed=n)
        np.testing.assert_allclose(svc.log_prob(x), jax_svc.log_prob(x), rtol=TOL, atol=TOL)
    # padding rows never leak into results
    x = _x(3, seed=4)
    np.testing.assert_allclose(svc.log_prob(x), svc.log_prob(np.concatenate([x, x]))[:3], rtol=TOL, atol=TOL)


def test_sample_shapes_paging_and_seeds(svc):
    assert [svc._bucket(n) for n in (1, 4, 5, 8, 9)] == [4, 4, 8, 8, 16]
    for n in (1, 4, 5, 8):
        x = svc.sample(n, seed=7)
        assert x.shape == (n, 100) and np.all(np.isfinite(x))
    x = svc.sample(19, seed=3)  # 3 pages of 8
    assert x.shape == (19, 100) and np.all(np.isfinite(x))
    assert not np.allclose(x[:8], x[8:16])
    np.testing.assert_array_equal(svc.sample(5, seed=11), svc.sample(5, seed=11))
    assert not np.allclose(svc.sample(5, seed=11), svc.sample(5, seed=12))
    assert not np.allclose(svc.sample(5), svc.sample(5))  # seed=None: fresh entropy
    # samples map back onto the latents they came from
    with torch.no_grad():
        z, _ = svc.model(torch.from_numpy(svc.sample(8, seed=5)))
    g = torch.Generator().manual_seed(5)
    np.testing.assert_allclose(z.numpy(), torch.randn((8, 100), generator=g).numpy(), atol=1e-4)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(svc):
    httpd = make_server(svc, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as resp:
            assert json.loads(resp.read()) == {"status": "ok", "config": NAME}
        code, out = _post(port, "/sample", {"n": 3, "seed": 1})
        assert code == 200
        x = np.asarray(out["x"], np.float32)
        np.testing.assert_array_equal(x, svc.sample(3, seed=1))
        code, out = _post(port, "/log_prob", {"x": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(out["log_prob"], svc.log_prob(x), rtol=TOL, atol=TOL)
        assert _post(port, "/sample", {"n": MAX_HTTP_SAMPLE_N + 1})[0] == 400
        assert _post(port, "/log_prob", {"x": [[1.0, 2.0]]})[0] == 400
        assert _post(port, "/nope", {})[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_registry_matches_jax():
    assert CONFIGS == JAX_CONFIGS
    assert list_configs("uci_data.") == tuple(sorted(k for k in JAX_CONFIGS if k.startswith("uci_data.")))
    for name in list_configs():
        p, j = get_config(name), jax_config(name)
        assert (p.ndim_x, p.ndim_y, p.ndim_z, p.is_conditional, p.is_uci, p.kind, p.suffix) == (
            j.ndim_x, j.ndim_y, j.ndim_z, j.is_conditional, j.is_uci, j.kind, j.suffix), name
    for name, kind in (("plus_shape.unconditional_inn_4", "Flow"), ("plus_shape.conditional_cinn_4", "Flow"),
                       ("lens_shape.conditional_hint_1_full", "TwoLaneFlow")):
        assert type(get_config(name).build_model(device="cpu")).__name__ == kind  # every family builds


def test_port_imports_no_jax():
    """Neither the package, its entry points nor chip_smoke.py pulls in JAX
    or any module of the JAX package; importing them does not import
    matplotlib either (a CUDA host may lack it: the figures import it
    when they draw)."""
    code = (
        "import sys, pkgutil, importlib, hint_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(hint_tpu_torch.__path__, 'hint_tpu_torch.')]\n"
        "assert {'hint_tpu_torch.train.trainer', 'hint_tpu_torch.data.fourier', 'hint_tpu_torch.cli', "
        "'hint_tpu_torch.ops.coupling', 'hint_tpu_torch.evaluation.sampling', 'hint_tpu_torch.data.native', "
        "'hint_tpu_torch.data.uci', 'hint_tpu_torch.evaluation.metrics', 'hint_tpu_torch.evaluation.mmd', "
        "'hint_tpu_torch.evaluation.shape_fit', 'hint_tpu_torch.evaluation.abc', "
        "'hint_tpu_torch.experiments', 'hint_tpu_torch.experiments.drivers', "
        "'hint_tpu_torch.experiments.campaign', 'hint_tpu_torch.monitor.plots', "
        "'hint_tpu_torch.monitor.figures', 'hint_tpu_torch.parallel.mesh', "
        "'hint_tpu_torch.parallel.dryrun'} <= set(names)\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'hint_tpu' or m.startswith('hint_tpu.')]\n"
        "assert not bad, bad\n"
        "drawing = [m for m in sys.modules if m == 'matplotlib' or m.startswith('matplotlib.')]\n"
        "assert not drawing, drawing\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_never_fall_back_to_cpu(monkeypatch, tmp_path, jax_side, port_cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceService(port_cfg, jax_side[2], buckets=(4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cfg.build_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cfg.make_trainer()
    for sub in (["train", "--n-train", "8"], ["evaluate", "--ckpt", "none.npz"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([*sub, "--config", NAME, "--cache-dir", str(tmp_path)])
    path = str(tmp_path / "p.npz")
    checkpoint.save_params_npz(path, jax_side[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["sample", "--config", NAME, "--ckpt", path, "--n", "2"])
    # the campaign's stages build their trainer before they load any data
    monkeypatch.setattr(campaign, "CAMPAIGN_DIR", str(tmp_path / "campaign"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        campaign.main(["train", "--family", "plus", "--configs", NAME, "--seeds", "0"])
    assert not os.path.exists(tmp_path / "campaign" / "train_log.json")


def test_make_trainer_carries_the_config(port_cfg):
    tr = port_cfg.make_trainer(impl="fused", lr_semantics="modern", remat=True, device="cpu")
    jtr = dataclasses.replace(jax_config(NAME), **SHRINK).make_trainer(lr_semantics="modern")
    for field in ("kind", "lr_init", "pre_low_lr", "final_decay", "n_epochs", "adam_betas", "l2_weight_reg",
                  "init_scale", "batch_size", "max_batches_per_epoch", "lr_semantics", "noise_std"):
        assert getattr(tr, field) == getattr(jtr, field), field
    assert tr.model.remat and tr.model.b0.impl == "fused" and tr.device == torch.device("cpu")
    assert tr.n_trainable_params(tr.init_state(0)) == sum(
        p.numel() for k, p in tr.model.named_parameters())


def test_cli_sample_on_cpu(tmp_path):
    name = "uci_data.power_hint_4"
    model = get_config(name).build_model(device="cpu")
    model.init(torch.Generator().manual_seed(0))
    ckpt, out = str(tmp_path / "m.npz"), str(tmp_path / "s.npy")
    checkpoint.save_params_npz(ckpt, model)
    cli.main(["sample", "--config", name, "--ckpt", ckpt, "--n", "5", "--out", out,
              "--device", "cpu", "--impl", "fused", "--seed", "3"])
    x = np.load(out)
    assert x.shape == (5, 6) and np.all(np.isfinite(x))
    svc = InferenceService.from_checkpoint(name, ckpt, device="cpu")
    np.testing.assert_allclose(x, svc.sample(5, seed=3), rtol=TOL, atol=TOL)


# -- conditional families ----------------------------------------------------------------------

COND = {
    "recursive_cinn": ("plus_shape.conditional_recursive_cinn_4", dict(n_blocks=2, c_internal=(16, 8))),
    "recursive_cinn-fused": ("plus_shape.conditional_recursive_cinn_4", dict(n_blocks=2, c_internal=(16, 8))),
    "cinn": ("lens_shape.conditional_cinn_2", dict(hidden=16)),
    "conditional_hint": ("lens_shape.conditional_hint_2_full", dict(c_internal=(16, 8), hidden=16, hidden_y=8)),
}


@pytest.fixture(scope="module", params=list(COND))
def cond_pair(request):
    """(JAX service, port service) of one shrunken conditional config over
    the same params (the JAX init, subnet weights halved)."""
    name, shrink = COND[request.param]
    jcfg = dataclasses.replace(jax_config(name), **shrink)
    params = jax.tree.map(np.array, jcfg.build_model().init(jax.random.PRNGKey(4)))
    for op in params.values():
        for sub in (v for v in op.values() if isinstance(v, dict)):
            for leaf in sub.values():
                leaf *= 0.5
    impl = "fused" if request.param.endswith("fused") else "levelwise"
    jsvc = JaxService(jcfg, jax.tree.map(jnp.asarray, params), buckets=(4, 8))
    svc = InferenceService(dataclasses.replace(get_config(name), **shrink), params, buckets=(4, 8),
                           impl=impl, device="cpu")
    return jsvc, svc


def test_conditional_service_log_prob_matches_jax(cond_pair):
    """log p(x | y) of the single-lane conditional models and the joint
    density over concat(z_x, z_y) of the two-lane one; y padded to the
    bucket; the default y is the config's vis_y_target on every row."""
    jsvc, svc = cond_pair
    dx, dy = svc.cfg.ndim_x, svc.cfg.ndim_y
    for n in (3, 8, 11):
        x, y = _x(n, dx, seed=n), _x(n, dy, seed=20 + n)
        np.testing.assert_allclose(svc.log_prob(x, y), jsvc.log_prob(x, y), rtol=TOL, atol=TOL)
    x = _x(3, dx, seed=5)
    np.testing.assert_allclose(svc.log_prob(x), jsvc.log_prob(x), rtol=TOL, atol=TOL)
    target = np.tile(np.asarray(svc.cfg.vis_y_target, np.float32), (3, 1))
    np.testing.assert_allclose(svc.log_prob(x), svc.log_prob(x, target), rtol=TOL, atol=TOL)
    assert not np.allclose(svc.log_prob(x), svc.log_prob(x, target + 1.0))
    with pytest.raises(ValueError, match="y must be"):
        svc.log_prob(x, target[:2])


def test_conditional_sample_follows_y_target(cond_pair):
    _, svc = cond_pair
    dx, dy = svc.cfg.ndim_x, svc.cfg.ndim_y
    default = svc.sample(5, seed=3)
    assert default.shape == (5, dx) and np.isfinite(default).all()
    np.testing.assert_array_equal(default, svc.sample(5, y_target=svc.cfg.vis_y_target, seed=3))
    other = svc.sample(5, y_target=[0.5] * dy, seed=3)
    assert not np.allclose(default, other)  # same latents, another condition
    paged = svc.sample(19, y_target=[0.5] * dy, seed=3)  # 3 pages of 8
    assert paged.shape == (19, dx) and np.isfinite(paged).all()
    # the samples map back onto their latents under the same condition
    y = torch.tensor([[0.5] * dy] * 8)
    z = torch.randn((8, dx), generator=torch.Generator().manual_seed(6))
    x = torch.from_numpy(svc.sample(8, y_target=[0.5] * dy, seed=6))
    with torch.no_grad():
        if svc._two_lane:
            z_back = svc.model(y, x)[1]
        else:
            z_back = svc.model(x, y)[0]
    np.testing.assert_allclose(z_back.numpy(), z.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match=f"y_target must have {dy} entries"):
        svc.sample(2, y_target=[1.0] * (dy + 1))
    no_default = InferenceService.__new__(InferenceService)
    no_default.cfg = dataclasses.replace(svc.cfg, vis_y_target=None)
    with pytest.raises(ValueError, match="y_target required"):
        no_default._y_for(2, None)
    assert no_default._y_for(2, [1.0] * dy).shape == (2, dy)


def test_conditional_http_round_trip(cond_pair):
    _, svc = cond_pair
    dy = svc.cfg.ndim_y
    httpd = make_server(svc, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_port
        code, out = _post(port, "/sample", {"n": 3, "seed": 1, "y_target": [0.5] * dy})
        assert code == 200
        x = np.asarray(out["x"], np.float32)
        np.testing.assert_array_equal(x, svc.sample(3, y_target=[0.5] * dy, seed=1))
        code, out = _post(port, "/sample", {"n": 3, "seed": 1})
        assert code == 200 and not np.allclose(np.asarray(out["x"], np.float32), x)  # vis_y_target
        y = _x(3, dy, seed=9)
        code, out = _post(port, "/log_prob", {"x": x.tolist(), "y": y.tolist()})
        assert code == 200
        np.testing.assert_allclose(out["log_prob"], svc.log_prob(x, y), rtol=TOL, atol=TOL)
        code, out = _post(port, "/sample", {"n": 3, "y_target": [0.5] * (dy + 1)})
        assert code == 400 and "y_target must have" in out["error"]
        assert _post(port, "/log_prob", {"x": x.tolist(), "y": y[:2].tolist()})[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_unconditional_service_ignores_y_target(svc):
    np.testing.assert_array_equal(svc.sample(3, seed=2), svc.sample(3, y_target=[1.0, 2.0], seed=2))
    assert svc._y_for(4, [1.0]).shape == (4, 0)


def test_sampling_functions_match_the_service_and_each_other(tmp_path):
    from hint_tpu_torch.evaluation import sample_conditional, sample_joint_hint, sample_model

    cfg = dataclasses.replace(get_config("lens_shape.conditional_hint_2_full"),
                              c_internal=(16, 8), hidden=16, hidden_y=8)
    model = cfg.build_model(device="cpu")
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
        g = lambda: torch.Generator().manual_seed(11)
        x = sample_model(cfg, model, 6, g(), y_target=(2.0, -1.0))
        assert x.shape == (6, 20) and bool(torch.isfinite(x).all())
        y = torch.tensor([[2.0, -1.0]] * 6)
        z_x = torch.randn((6, 20), generator=g())
        np.testing.assert_allclose(sample_conditional(model, y, g()).numpy(),
                                   sample_conditional(model, y, g(), z_x=z_x).numpy(), atol=1e-6)
        ys, xs = sample_joint_hint(model, 6, g())
        assert ys.shape == (6, 2) and xs.shape == (6, 20)
        z_y, z_x2, _, _ = model(ys, xs)  # the joint sample maps back onto N(0, I) draws
        gj = g()
        np.testing.assert_allclose(z_y.numpy(), torch.randn((6, 2), generator=gj).numpy(), atol=1e-4)
        np.testing.assert_allclose(z_x2.numpy(), torch.randn((6, 20), generator=gj).numpy(), atol=1e-4)
        rc_cfg = dataclasses.replace(get_config("plus_shape.conditional_recursive_cinn_4"),
                                     n_blocks=1, c_internal=(16, 8))
        rc = rc_cfg.build_model(device="cpu")
        rc.init(torch.Generator().manual_seed(1))
        for p in rc.parameters():
            p.mul_(0.5)
        xr = sample_model(rc_cfg, rc, 4, g(), y_target=rc_cfg.vis_y_target)
        zr, _ = rc(xr, torch.tensor([rc_cfg.vis_y_target] * 4, dtype=torch.float32))
        np.testing.assert_allclose(zr.numpy(), torch.randn((4, 100), generator=g()).numpy(), atol=1e-4)
        un_cfg = dataclasses.replace(get_config(NAME), **SHRINK)
        un = un_cfg.build_model(device="cpu")
        un.init(torch.Generator().manual_seed(2))
        assert sample_model(un_cfg, un, 3, g()).shape == (3, 100)
    with torch.no_grad(), one_rank_mesh(tmp_path) as mesh:  # the sharded path over one rank
        np.testing.assert_array_equal(sample_model(cfg, model, 6, g(), y_target=(2.0, -1.0), mesh=mesh).numpy(), x.numpy())


def test_cli_conditional_train_evaluate_sample_on_cpu(tmp_path, capsys):
    name = "lens_shape.conditional_hint_1_full"
    ckpt, out = str(tmp_path / "run.npz"), str(tmp_path / "s.npy")
    data = ["--config", name, "--device", "cpu", "--n-train", "64", "--n-test", "32",
            "--cache-dir", str(tmp_path / "data")]
    final = cli.main(["train", *data, "--impl", "fused", "--epochs", "2", "--batch-size", "16", "--save", ckpt])
    text = capsys.readouterr().out
    assert "265,839 trainable parameters" in text and np.isfinite(final)
    total = cli.main(["evaluate", *data, "--ckpt", ckpt])
    text = capsys.readouterr().out
    assert np.isfinite(total) and "x-lane NLL" in text
    common = ["sample", "--config", name, "--device", "cpu", "--ckpt", ckpt, "--n", "5", "--out", out]
    cli.main([*common, "--y-target", "2.0", "-1.0"])
    x = np.load(out)
    assert x.shape == (5, 20) and np.isfinite(x).all()
    cli.main(common)  # the default is the config's vis_y_target = (2.0, -1.0)
    np.testing.assert_array_equal(np.load(out), x)
    cli.main([*common, "--y-target", "0.0", "1.0"])
    assert not np.allclose(np.load(out), x)
    svc = InferenceService.from_checkpoint(name, ckpt, device="cpu")
    np.testing.assert_array_equal(x, svc.sample(5, y_target=(2.0, -1.0), seed=0))
    cinn = "lens_shape.conditional_cinn_1"  # a single-lane conditional config trains on (x, y) too
    final = cli.main(["train", "--config", cinn, "--device", "cpu", "--n-train", "64", "--n-test", "32",
                      "--cache-dir", str(tmp_path / "data"), "--epochs", "1", "--batch-size", "16"])
    assert np.isfinite(final) and "x-lane NLL" not in capsys.readouterr().out
