"""The port's entry points (``hint_tpu_torch.entry``) against
``__graft_entry__`` on the CPU.

The JAX entry's parameters (``init_state(PRNGKey(0))``) go into the port
through ``convert.params_from_numpy``; both functions then take the same
64 rows from a numpy seed. Threefry cannot be reproduced in torch, so the
port's own ``x`` and parameters are held to their shapes and seeds only.
Tolerance: 1e-5 relative in f32, the bound the port holds every forward
to (``BASELINE.md``).
"""

from __future__ import annotations

import os
import subprocess
import sys

import __graft_entry__ as graft
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu_torch import convert
from hint_tpu_torch.configs import get_config
from hint_tpu_torch.entry import ENTRY_ROWS, entry
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.utils import instrument

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 64
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's function, its parameters as numpy and 64 rows."""
    fn, (params, x) = graft.entry()
    assert x.shape == (ENTRY_ROWS, 100)
    rows = np.random.default_rng(0).standard_normal((ROWS, 100)).astype(np.float32)
    return fn, jax.device_get(params), rows


@pytest.fixture(scope="module")
def port_entry():
    return entry(device="cpu")


def test_fn_matches_graft_entry_on_injected_params_and_rows(jax_entry, port_entry):
    jfn, jparams, rows = jax_entry
    ref = float(jfn(jparams, jnp.asarray(rows)))
    fn, _ = port_entry
    got = float(fn(convert.params_from_numpy(jparams), torch.from_numpy(rows)))
    assert np.isfinite(ref) and abs(got - ref) <= TOL * abs(ref), (got, ref)


def test_params_have_the_jax_trees_keys_and_shapes_and_x_its_shape(jax_entry, port_entry):
    _, jparams, _ = jax_entry
    _, (params, x) = port_entry
    ref = {k: tuple(v.shape) for k, v in convert._flat(jparams)}
    assert {k: tuple(v.shape) for k, v in params.items()} == ref
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in params.values())
    assert x.shape == (ENTRY_ROWS, 100) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), torch.randn((ENTRY_ROWS, 100), generator=torch.Generator()
                                                         .manual_seed(1)).numpy())


def test_fn_is_a_function_of_its_arguments(port_entry):
    fn, (params, x) = port_entry
    half = {k: v * 0.5 for k, v in params.items()}
    a, b = float(fn(params, x[:ROWS])), float(fn(half, x[:ROWS]))
    assert np.isfinite(a) and np.isfinite(b) and a != b
    assert float(fn(params, x[:ROWS])) == a  # the first dict again: its own loss
    assert float(fn(params, x[ROWS : 2 * ROWS])) != a


def test_fused_entry_takes_the_plain_version_on_the_cpu(port_entry):
    fn, (params, x) = port_entry
    fused, (fused_params, fused_x) = entry(device="cpu", impl="fused")
    assert torch.equal(fused_x, x) and all(torch.equal(fused_params[k], params[k]) for k in params)
    before = instrument.get("hac.launches")
    assert float(fused(params, x[:ROWS])) == float(fn(params, x[:ROWS])) and instrument.get("hac.launches") == before


def test_entry_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_pack_key_never_repeats_for_a_new_tensor_at_the_same_address():
    """The kernel's packed weights of a block evaluated on a parameter dict
    (as ``fn`` does) are rebuilt for a second dict whose tensors are new
    objects at the same addresses and at ``_version`` 0 (here: made from
    the same numpy buffers, whose values changed in between)."""
    _, (params, _) = entry(device="cpu")
    model = get_config(graft.FLAGSHIP).build_model(impl="fused", device="cpu")
    hac = model.b0
    arrays = {k: v.numpy().copy() for k, v in params.items()}

    def pack(tensors):
        with torch.nn.utils.stateless._reparametrize_module(model, tensors):
            return hac_fused._packed(hac, torch.device("cpu"))

    first = {k: torch.from_numpy(a) for k, a in arrays.items()}
    a = pack(first)
    assert pack(first) is a
    ptrs = {k: t.data_ptr() for k, t in first.items()}
    del first
    for arr in arrays.values():
        arr *= 0.5
    second = {k: torch.from_numpy(a) for k, a in arrays.items()}
    assert {k: (t.data_ptr(), t._version) for k, t in second.items()} == {k: (p, 0) for k, p in ptrs.items()}
    b = pack(second)
    assert b is not a and torch.equal(b.weights, 0.5 * a.weights)


def test_module_runs_the_entry_and_a_one_rank_dryrun_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "hint_tpu_torch.entry", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("entry loss: ") and np.isfinite(float(lines[0].split(": ")[1]))
    assert any(line.startswith("dryrun OK: 1 ranks (gloo, cpu)") for line in lines), out.stdout
