"""The port's serving slice against the JAX package: a 2-block ``hint``
Flow (d=100, narrow c_internal), checkpoints in both directions, the
inference service and its HTTP API, the registry, and the port's
isolation from JAX. Inputs and params are made with numpy / the JAX
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
from hint_tpu_torch.serve import MAX_HTTP_SAMPLE_N, InferenceService, make_server
from hint_tpu_torch.train import checkpoint

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
    for name in (NAME, "uci_data.power_hint_4", "lens_shape.conditional_hint_4_full"):
        p, j = get_config(name), jax_config(name)
        assert (p.ndim_x, p.ndim_y, p.is_conditional) == (j.ndim_x, j.ndim_y, j.is_conditional)
    for name, item in (("plus_shape.unconditional_inn_4", "M3"), ("plus_shape.conditional_cinn_4", "M7")):
        with pytest.raises(NotImplementedError, match=item):
            get_config(name).build_model(device="cpu")


def test_port_imports_no_jax():
    """Neither the package, its entry points nor chip_smoke.py pulls in JAX
    or any module of the JAX package."""
    code = (
        "import sys, hint_tpu_torch, hint_tpu_torch.serve, hint_tpu_torch.cli, "
        "hint_tpu_torch.ops.hac_fused, hint_tpu_torch.train.checkpoint, chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'hint_tpu' or m.startswith('hint_tpu.')]\n"
        "assert not bad, bad\n"
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
    path = str(tmp_path / "p.npz")
    checkpoint.save_params_npz(path, jax_side[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["sample", "--config", NAME, "--ckpt", path, "--n", "2"])


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
