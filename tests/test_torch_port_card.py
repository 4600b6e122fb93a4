"""Card-only tests of the port: the hac_block CUDA kernel against its plain
version, alone and under autograd, with and without a condition, its
backward kernels against theirs, the fused serving path against the
levelwise one, fused training against levelwise training (the flagship
and a small condition-fed ``recursive_cinn``), the kernels on the shallow
blocks of the UCI configs (d=6, 8, 42), quantile-ABC's top-k on the
card, the device prior sweeps (``data/{lens,plus}_tpu.py``) against the
same functions on the CPU, a 1-rank NCCL world of data-parallel steps
against the single process, and the port's entry points (the fused
bench's launches a step; ``entry()`` fused against levelwise, and on a
second parameter dict made after the first is freed).

They need a CUDA card and skip without one (the kernel has no CPU mode);
this file imports no JAX so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_card.py -q

Tolerances: f32 1e-4 (the kernel sums each product in another order than
the plain version's matmuls, through 7 levels of exp-scaled couplings);
bf16 2e-2 (both round the same activations to bf16, but an activation on a
rounding boundary can land one bf16 ulp apart); gradients through
``_FusedBlock`` (the backward kernels) against the plain version run in
float64 on a ``double()`` copy of the block: per leaf, |d| <= tol * (1 + the
leaf's largest |ref|), the kernels' error at most twice the f32 plain
version's own and at most 1e-4 (both sum in other orders over values with
cancellation; an entry near 0 carries the rounding of its largest terms),
bf16 2e-2 against the bf16 plain version; fused against levelwise per-step
training loss 1e-4 of 1+|loss| (f32: the forward sums in another order).
The backward kernels read the saved buffer of a saving forward
(``hac_fused._run_block(..., saved=)``), so their ReLU masks are the forward
kernel's.
"""

import copy

import numpy as np
import pytest
import torch

from hint_tpu_torch.configs import get_config
from hint_tpu_torch.convert import params_to_numpy
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.serve import InferenceService
from hint_tpu_torch.utils import instrument

FLAGSHIP = "plus_shape.unconditional_hint_4_full"
# the HAC block of the flagship and the condition-fed one of
# plus_shape.conditional_recursive_cinn_4: (c_internal, cond_dim)
BLOCKS = {"flagship": ((263, 131, 65, 32, 32), 0), "conditional": ((267, 133, 66), 4)}
# the HAC block of each UCI config uci_data.{power,gas,miniboone}_hint_4:
# (dim, c_internal, training batch)
UCI_BLOCKS = {"power": (6, (200, 100, 50, 25), 1660), "gas": (8, (184, 92, 46, 23), 853),
              "miniboone": (42, (102, 51, 25, 12), 300)}

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hac_block kernel has no CPU mode")
    return torch.device("cuda")


def _block(compute_dtype, device, c_internal=(263, 131, 65, 32, 32), cond_dim=0, dim=100):
    """HAC block at d=100 (the flagship's unless told otherwise) from
    model.init, noise in every padded entry, the rows [split, in_max) of a
    condition-fed block's w0 included."""
    hac = HierarchicalAffineCoupling(
        dim=dim, c_internal=c_internal, compute_dtype=compute_dtype, impl="fused", cond_dim=cond_dim
    )
    hac.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for li, lv in enumerate(hac.levels):
            p, n = hac.level_params(li), len(lv.nodes)
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                out_i = nd.dim - nd.split
                for t in (p["w0"][u, nd.split : lv.in_max], p["w2"][u, :, out_i:], p["b2"][u, out_i:]):
                    t.copy_(torch.randn(t.shape, generator=g))
    return hac.to(device)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_kernel_matches_plain_on_card(cuda, compute_dtype, tol):
    hac = _block(compute_dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    for b in (37, 64, 4096):
        x = torch.randn((b, 100), generator=g, device=cuda)
        for rev in (False, True):
            with torch.no_grad():
                before = instrument.get("hac.launches")
                yk, ldk = hac_fused.fused_block(hac, x, None, rev)
                assert instrument.get("hac.launches") == before + 1
                yp, ldp = hac_fused.plain_block(hac, x, None, rev)
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yp, rtol=tol, atol=tol)
            torch.testing.assert_close(ldk, ldp, rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_conditional_kernel_matches_plain_on_card(cuda, compute_dtype, tol):
    """The condition-fed block of plus_shape.conditional_recursive_cinn_4."""
    hac = _block(compute_dtype, cuda, c_internal=(267, 133, 66), cond_dim=4)
    g = torch.Generator(device=cuda).manual_seed(6)
    for b in (37, 64, 4096):
        x = torch.randn((b, 100), generator=g, device=cuda)
        c = torch.randn((b, 4), generator=g, device=cuda)
        for rev in (False, True):
            with torch.no_grad():
                before = instrument.get("hac.launches")
                yk, ldk = hac_fused.fused_block(hac, x, c, rev)
                assert instrument.get("hac.launches") == before + 1
                yp, ldp = hac_fused.plain_block(hac, x, c, rev)
                y0, _ = hac_fused.fused_block(hac, x, torch.zeros_like(c), rev)
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yp, rtol=tol, atol=tol)
            torch.testing.assert_close(ldk, ldp, rtol=tol, atol=tol)
            assert float((yk - y0).abs().max()) > 1e-3  # the condition is read
    with pytest.raises(ValueError, match="cond_dim=4"):
        hac_fused.fused_block(hac, x, None)
    with pytest.raises(ValueError, match="float32 condition"):
        hac_fused.fused_block(hac, x, c[:, :3])


def _route(name, compute_dtype):
    """A route of the forward kernel by name: the dtype's tensor cores
    (3xTF32 in f32, wgmma in bf16) or the first port's CUDA-core loop."""
    if name == "cuda_core_loop":
        return hac_fused.ROUTE_LOOP
    return hac_fused.ROUTE_TC if compute_dtype == "float32" else hac_fused.ROUTE_WG


@pytest.mark.parametrize("route", ["tensor_cores", "cuda_core_loop"])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_kernel_routes_match_plain_on_card(cuda, kind, compute_dtype, tol, route):
    """Each route of the forward kernel (``hac_block_launch_route``: the
    dtype's tensor cores, 3xTF32 in f32 and wgmma in bf16, and the first
    port's CUDA-core loop) against the plain version, forward and inverse,
    ragged and full tiles (37 and 300 rows: 32-, 64- and 16-row tiles); the
    dtype's own route (``hac_fused._FWD_ROUTE``) is one of them and gives
    the same bits through ``fused_block``."""
    c_internal, cond_dim = BLOCKS[kind]
    code = _route(route, compute_dtype)
    hac = _block(compute_dtype, cuda, c_internal=c_internal, cond_dim=cond_dim)
    g = torch.Generator(device=cuda).manual_seed(11)
    for b in (37, 300):
        x = torch.randn((b, 100), generator=g, device=cuda)
        c = torch.randn((b, cond_dim), generator=g, device=cuda) if cond_dim else None
        for rev in (False, True):
            with torch.no_grad():
                before = instrument.get("hac.launches")
                yk, ldk = hac_fused._run_block(hac, x, c, rev, code)
                assert instrument.get("hac.launches") == before + 1
                yp, ldp = hac_fused.plain_block(hac, x, c, rev)
                yd, ldd = hac_fused.fused_block(hac, x, c, rev)
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yp, rtol=tol, atol=tol)
            torch.testing.assert_close(ldk, ldp, rtol=tol, atol=tol)
            if code == hac_fused._FWD_ROUTE[compute_dtype]:
                assert torch.equal(yd, yk) and torch.equal(ldd, ldk)


@pytest.mark.parametrize("route", ["tensor_cores", "cuda_core_loop"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_kernel_routes_keep_an_inf_in_its_row_on_card(cuda, kind, compute_dtype, route):
    """An Inf in the first column of one row of x (and of the condition)
    changes no other row: rows are independent, and no read past a node's
    split or the condition's width may meet it (the rows before it in the
    tile are where such a read lands). Every other row is bit-identical to
    the run without the Inf."""
    c_internal, cond_dim = BLOCKS[kind]
    code = _route(route, compute_dtype)
    hac = _block(compute_dtype, cuda, c_internal=c_internal, cond_dim=cond_dim)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((64, 100), generator=g, device=cuda)
    c = torch.randn((64, cond_dim), generator=g, device=cuda) if cond_dim else None
    bad = [5, 32, 47]  # inside a tile, a tile's first row, the row after a 16-row tile
    xi = x.clone()
    xi[bad, 0] = float("inf")
    ci = None
    if cond_dim:
        ci = c.clone()
        ci[bad, 0] = float("inf")
    keep = torch.ones(64, dtype=torch.bool, device=cuda)
    keep[bad] = False
    for rev in (False, True):
        with torch.no_grad():
            y, ld = hac_fused._run_block(hac, x, c, rev, code)
            yi, ldi = hac_fused._run_block(hac, xi, ci, rev, code)
        torch.cuda.synchronize()
        assert torch.isfinite(yi[keep]).all() and torch.isfinite(ldi[keep]).all()
        assert torch.equal(yi[keep], y[keep]) and torch.equal(ldi[keep], ld[keep])


def _leaf_err(got, ref):
    """Worst |d| / (1 + max |ref|) over the leaves (None entries skipped)."""
    return max(
        float((a.double() - b.double()).abs().max() / (1 + b.double().abs().max()))
        for a, b in zip(got, ref) if b is not None
    )


def _grad_check_f64(hac, kernel_grads, plain_grads, x, c, rev, r, q, needs):
    """The kernels' and the f32 plain version's errors against the plain
    version in float64; the kernels' at most twice the plain one's and 1e-4."""
    h64 = copy.deepcopy(hac).double()
    d = lambda t: None if t is None else t.double()  # noqa: E731
    ref = hac_fused.plain_block_grad(h64, d(x), d(c), rev, d(r), d(q), needs)
    k_err, p_err = _leaf_err(kernel_grads, ref), _leaf_err(plain_grads, ref)
    assert k_err <= 2 * p_err and k_err <= 1e-4, (k_err, p_err)


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
def test_conditional_fused_block_gradients_match_plain_on_card(cuda, rev):
    """Gradients for x, the condition and every level parameter."""
    hac = _block("float32", cuda, c_internal=(267, 133, 66), cond_dim=4)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((300, 100), generator=g, device=cuda)
    c = torch.randn((300, 4), generator=g, device=cuda)
    r = torch.randn((300, 100), generator=g, device=cuda)
    q = torch.randn((300,), generator=g, device=cuda)
    grads = {}
    for name, fn in (("fused", hac_fused.fused_block), ("plain", hac_fused.plain_block)):
        xg, cg = x.clone().requires_grad_(), c.clone().requires_grad_()
        before = instrument.get("hac.launches")
        y, ld = fn(hac, xg, cg, rev)
        assert instrument.get("hac.launches") == before + (name == "fused")
        grads[name] = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [xg, cg, *hac.parameters()])
    assert float(grads["fused"][1].abs().max()) > 0
    needs = (True,) * len(grads["plain"])
    _grad_check_f64(hac, grads["fused"], grads["plain"], x, c, rev, r, q, needs)


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_backward_kernels_match_plain_on_card(cuda, kind, compute_dtype, rev):
    """The backward kernels (2 launches with level gradients, 1 without)
    over the saved buffer of a saving forward against plain_block_grad at
    batch 300 (ragged against the 32-row tile; in f32 against float64 per
    leaf), bit-identical over two calls, exact zeros at every padded
    entry."""
    c_internal, cond_dim = BLOCKS[kind]
    hac = _block(compute_dtype, cuda, c_internal=c_internal, cond_dim=cond_dim)
    g = torch.Generator(device=cuda).manual_seed(10)
    x, r = torch.randn((300, 100), generator=g, device=cuda), torch.randn((300, 100), generator=g, device=cuda)
    q = torch.randn((300,), generator=g, device=cuda)
    c = torch.randn((300, cond_dim), generator=g, device=cuda) if cond_dim else None
    names = [k for k, _ in hac.named_parameters()]
    needs = (True, cond_dim > 0, *(True,) * len(names))
    saved = _saving_forward(hac, x, c, rev)
    before = (instrument.get("hac.bwd_launches"), instrument.get("hac.bwd_weight_launches"))
    k1 = hac_fused._run_block_grad(hac, saved, c, rev, r, q, needs)
    after = (instrument.get("hac.bwd_launches"), instrument.get("hac.bwd_weight_launches"))
    assert tuple(b - a for a, b in zip(before, after)) == (2, 1)
    k2 = hac_fused._run_block_grad(hac, saved, c, rev, r, q, needs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k1, k2) if a is not None)
    plain = hac_fused.plain_block_grad(hac, x, c, rev, r, q, needs)
    if compute_dtype == "float32":
        _grad_check_f64(hac, k1, plain, x, c, rev, r, q, needs)
    else:
        assert _leaf_err(k1, plain) <= 2e-2
    grads = dict(zip(names, k1[2:]))
    for li, lv in enumerate(hac.levels):
        for u in range(2 * len(lv.nodes)):
            nd = lv.nodes[u % len(lv.nodes)]
            out_i = nd.dim - nd.split
            for t in (grads[f"L{li}.w0"][u, nd.split : lv.in_max], grads[f"L{li}.w2"][u, :, out_i:],
                      grads[f"L{li}.b2"][u, out_i:]):
                assert not bool(t.any())
    before = instrument.get("hac.bwd_launches")
    only_x = hac_fused._run_block_grad(hac, saved, c, rev, r, q, (True, cond_dim > 0) + (False,) * len(names))
    assert instrument.get("hac.bwd_launches") == before + 1 and all(t is None for t in only_x[2:])
    assert torch.equal(only_x[0], k1[0])


def _saving_forward(hac, x, c, rev):
    """The saved buffer of a saving forward of ``x`` (one launch)."""
    saved = hac_fused.saved_buffer(hac, x)
    with torch.no_grad():
        hac_fused._run_block(hac, x, c, rev, saved=saved)
    return saved


def _plain_activations(hac, x, c, rev):
    """The plain version's per-level input, S (both (B, d)), a1 and a2 (B, 2 n,
    h; the levelwise engine's ReLU outputs, units in the packed order) keyed
    by workspace region (level, 0 / 1 / 4 / 5), and the block's output
    (None, 0): one no-grad pass with its ReLUs and level calls recorded."""
    seen, relu, level_st, out = [], torch.relu, hac._level_st, {}

    def recording_relu(t):
        seen.append(relu(t))
        return seen[-1]

    def recording_level(li, xx, *a, **k):
        s, t = level_st(li, xx, *a, **k)
        out[(li, 0)], out[(li, 1)] = xx.clone(), hac._scatter_lower(li, s)
        return s, t

    torch.relu, hac._level_st = recording_relu, recording_level
    try:
        with torch.no_grad():
            out[(None, 0)] = hac_fused.plain_block(hac, x, c, rev)[0]
    finally:
        torch.relu = relu
        del hac._level_st
    order = range(len(hac.levels)) if rev else reversed(range(len(hac.levels)))
    for k, li in enumerate(order):
        out[(li, 4)], out[(li, 5)] = (a.flatten(0, 1).transpose(0, 1) for a in seen[2 * k : 2 * k + 2])
    return out


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_saved_regions_match_plain_activations_on_card(cuda, kind, compute_dtype, tol, rev):
    """A saving forward's regions (every level's input and S, every unit's a1
    and a2, the block's output) against the plain version's activations, at
    the forward kernel's tolerances, by the route that a saving forward
    takes in the dtype (the tiled route in f32, the wgmma route in bf16); its y and
    log-det equal those of that route without saving bit for bit and the
    output region holds y; the 3xTF32 route refuses a saved buffer; a
    forward without saving holds no workspace."""
    c_internal, cond_dim = BLOCKS[kind]
    hac = _block(compute_dtype, cuda, c_internal=c_internal, cond_dim=cond_dim)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((300, 100), generator=g, device=cuda)
    c = torch.randn((300, cond_dim), generator=g, device=cuda) if cond_dim else None
    with torch.no_grad():
        hac_fused.fused_block(hac, x, c, rev)  # packs the weights
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, ld = hac_fused.fused_block(hac, x, c, rev)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= 2 * (y.numel() + ld.numel()) * 4  # y, logdet only
    bwd = hac_fused._packed(hac, x.device).bwd
    ref = _plain_activations(hac, x, c, rev)
    assert len(ref) == 4 * len(hac.levels) + 1
    saved = hac_fused.saved_buffer(hac, x)
    with torch.no_grad():
        y_s, ld_s = hac_fused._run_block(hac, x, c, rev, saved=saved)
        y, ld = hac_fused._run_block(hac, x, c, rev, hac_fused._SAVE_ROUTE[compute_dtype])
        with pytest.raises(ValueError, match="not 3xTF32" if compute_dtype == "float32" else "no route"):
            hac_fused._run_block(hac, x, c, rev, hac_fused.ROUTE_TC, saved)
    assert torch.equal(y, y_s) and torch.equal(ld, ld_s)
    assert torch.equal(hac_fused.workspace_region(hac, bwd, 300, saved, None), y)
    for (li, k), want in ref.items():
        got = hac_fused.workspace_region(hac, bwd, 300, saved, li, k)
        err = float((got - want).abs().max() / (1 + want.abs().max()))
        assert err <= tol, (li, k, err)


@pytest.mark.parametrize("route", ["wgmma", "cuda_core_loop"])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_bf16_routes_save_what_the_plain_version_computes_on_card(cuda, kind, route):
    """In bf16 each route that can save (the wgmma route, the loop): a
    saving forward's regions against the
    bf16 plain version's activations within 2e-2 of 1 + the region's max
    |ref|, its y and log-det against the plain version's within 2e-2 of
    1+|ref| and bit-identical to the same route without saving, forward and
    inverse, at 37 and 300 rows; each launch counted once, and by the wgmma
    count where the route is wgmma's."""
    c_internal, cond_dim = BLOCKS[kind]
    code = {"wgmma": hac_fused.ROUTE_WG, "cuda_core_loop": hac_fused.ROUTE_LOOP}[route]
    hac = _block("bfloat16", cuda, c_internal=c_internal, cond_dim=cond_dim)
    g = torch.Generator(device=cuda).manual_seed(13)
    bwd = hac_fused._packed(hac, cuda).bwd
    for b in (37, 300):
        x = torch.randn((b, 100), generator=g, device=cuda)
        c = torch.randn((b, cond_dim), generator=g, device=cuda) if cond_dim else None
        for rev in (False, True):
            saved = hac_fused.saved_buffer(hac, x)
            before = (instrument.get("hac.launches"), instrument.get("hac.launches.wgmma"))
            with torch.no_grad():
                y_s, ld_s = hac_fused._run_block(hac, x, c, rev, code, saved)
                y, ld = hac_fused._run_block(hac, x, c, rev, code)
                yp, ldp = hac_fused.plain_block(hac, x, c, rev)
            torch.cuda.synchronize()
            launched = (instrument.get("hac.launches") - before[0], instrument.get("hac.launches.wgmma") - before[1])
            assert launched == (2, 2 * (code != hac_fused.ROUTE_LOOP))
            assert torch.equal(y, y_s) and torch.equal(ld, ld_s)
            torch.testing.assert_close(y, yp, rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(ld, ldp, rtol=2e-2, atol=2e-2)
            for (li, k), want in _plain_activations(hac, x, c, rev).items():
                got = hac_fused.workspace_region(hac, bwd, b, saved, li, k)
                err = float((got - want).abs().max() / (1 + want.abs().max()))
                assert err <= 2e-2, (li, k, err)


# the tiled route's bitwise check against the loop: (dim, c_internal,
# cond_dim, max_splits, batches): the condition-fed block of
# plus_shape.conditional_recursive_cinn_4 at its training batch and ragged
# ones, the flagship's, the campaign's widths, and the UCI blocks at their
# training batches
TILED_CASES = {
    "conditional": (100, (267, 133, 66), 4, -1, (37, 1660, 10_000)),
    "flagship": (100, (263, 131, 65, 32, 32), 0, -1, (37, 10_000)),
    "campaign_x_lane": (100, (224, 112, 56), 0, -1, (10_000,)),
    "grid_4_1": (100, (358, 179), 0, 1, (10_000,)),
    "power": (6, (200, 100, 50, 25), 0, -1, (1660,)),
    "gas": (8, (184, 92, 46, 23), 0, -1, (853,)),
    "miniboone": (42, (102, 51, 25, 12), 0, -1, (300,)),
}


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", list(TILED_CASES))
def test_tiled_saving_forward_is_the_loops_bit_for_bit_on_card(cuda, kind):
    """The f32 saving forward's route (``hac_fused._SAVE_ROUTE``, the tiled
    route) against the loop's saving forward, forward and inverse (the
    directions ``_FusedBlock`` saves in): y, the log-det and every region of
    the saved buffer (each level's input and S, each unit's a1 and a2, the
    block's output) equal bit for bit; its pass without saving gives the
    same y and log-det; each tiled launch counted by ``hac.launches.tiled``.
    An Inf in one row of x (and of the condition) leaves every other row
    bit-identical."""
    dim, c_internal, cond_dim, max_splits, batches = TILED_CASES[kind]
    assert hac_fused._SAVE_ROUTE["float32"] == hac_fused.ROUTE_TILED
    hac = HierarchicalAffineCoupling(dim=dim, c_internal=c_internal, cond_dim=cond_dim, compute_dtype="float32",
                                     impl="fused", max_splits=max_splits)
    hac.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in hac.parameters():  # trained-like weights, noise in every padded entry
            p.copy_(torch.randn(p.shape, generator=g) / p.shape[-2] ** 0.5 if p.dim() == 3 else
                    0.05 * torch.randn(p.shape, generator=g))
    hac = hac.to(cuda)
    bwd = hac_fused._packed(hac, cuda).bwd
    g = torch.Generator(device=cuda).manual_seed(14)
    for b in batches:
        x = torch.randn((b, dim), generator=g, device=cuda)
        c = torch.randn((b, cond_dim), generator=g, device=cuda) if cond_dim else None
        for rev in (False, True):
            out = {}
            for code in (hac_fused.ROUTE_TILED, hac_fused.ROUTE_LOOP):
                saved = hac_fused.saved_buffer(hac, x)
                before = instrument.get("hac.launches.tiled")
                with torch.no_grad():
                    y, ld = (hac_fused._run_block(hac, x, c, rev, saved=saved) if code == hac_fused.ROUTE_TILED
                             else hac_fused._run_block(hac, x, c, rev, code, saved))
                assert instrument.get("hac.launches.tiled") - before == int(code == hac_fused.ROUTE_TILED)
                out[code] = (y, ld, saved)
            torch.cuda.synchronize()
            (y, ld, sv), (yl, ldl, svl) = out[hac_fused.ROUTE_TILED], out[hac_fused.ROUTE_LOOP]
            assert torch.isfinite(y).all() and torch.isfinite(ld).all()
            assert torch.equal(_bits(y), _bits(yl)) and torch.equal(_bits(ld), _bits(ldl)), (b, rev)
            regions = [(li, k) for li in range(len(hac.levels)) for k in (0, 1, 4, 5)] + [(None, 0)]
            for li, k in regions:
                got = hac_fused.workspace_region(hac, bwd, b, sv, li, k)
                want = hac_fused.workspace_region(hac, bwd, b, svl, li, k)
                assert torch.equal(_bits(got), _bits(want)), (b, rev, li, k)
            with torch.no_grad():
                yn, ldn = hac_fused._run_block(hac, x, c, rev, hac_fused.ROUTE_TILED)
            assert torch.equal(_bits(yn), _bits(y)) and torch.equal(_bits(ldn), _bits(ld))
    # an Inf in rows of the last batch: every other row as before, bit for bit
    bad = [5, 16, b - 1]  # inside a tile, a 16-row tile's first row, the last row
    xi = x.clone()
    xi[bad, 0] = float("inf")
    ci = None
    if cond_dim:
        ci = c.clone()
        ci[bad, 0] = float("inf")
    keep = torch.ones(b, dtype=torch.bool, device=cuda)
    keep[bad] = False
    with torch.no_grad():
        yi, ldi = hac_fused._run_block(hac, xi, ci, False, hac_fused.ROUTE_TILED)
        y, ld = hac_fused._run_block(hac, x, c, False, hac_fused.ROUTE_TILED)
    assert torch.equal(_bits(yi[keep]), _bits(y[keep])) and torch.equal(_bits(ldi[keep]), _bits(ld[keep]))


def test_remat_step_holds_less_memory_on_card(cuda):
    """With ``remat=True`` a fused flagship step checkpoints its blocks: the
    saved buffers are dropped after each block's forward and rebuilt one at
    a time in the backward, so the step allocates less than without it, at
    the same loss."""
    x = torch.randn((4096, 100), generator=torch.Generator(device=cuda).manual_seed(13), device=cuda) * 0.2
    peaks, losses = {}, {}
    for remat in (False, True):
        trainer = get_config(FLAGSHIP).make_trainer(impl="fused", remat=remat, device=cuda)
        state = trainer.init_state(0)
        gen = torch.Generator(device=cuda).manual_seed(14)
        trainer.train_step(state, x, None, gen, 3e-4)  # packs, layouts, optimizer state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses[remat] = trainer.train_step(state, x, None, gen, 3e-4)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
    assert peaks[True] < peaks[False], peaks
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-6, atol=0)


def test_fused_service_matches_levelwise_on_card(cuda):
    model = get_config(FLAGSHIP).build_model(device="cpu")
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)  # keeps the random 4-block inverse finite in f32
    params = params_to_numpy(model)
    fused = InferenceService(get_config(FLAGSHIP), params, impl="fused", device=cuda)
    plain = InferenceService(get_config(FLAGSHIP), params, impl="levelwise", device=cuda)
    x = fused.sample(300, seed=0)
    assert np.all(np.isfinite(x))
    np.testing.assert_allclose(x, plain.sample(300, seed=0), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(fused.log_prob(x), plain.log_prob(x), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
def test_fused_block_gradients_match_plain_on_card(cuda, rev):
    hac = _block("float32", cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((300, 100), generator=g, device=cuda)
    r = torch.randn((300, 100), generator=g, device=cuda)
    q = torch.randn((300,), generator=g, device=cuda)
    grads = {}
    for name, fn in (("fused", hac_fused.fused_block), ("plain", hac_fused.plain_block)):
        xg = x.clone().requires_grad_()
        before = instrument.get("hac.launches")
        y, ld = fn(hac, xg, None, rev)
        assert instrument.get("hac.launches") == before + (name == "fused")
        assert (type(y.grad_fn).__name__ == "_FusedBlockBackward") == (name == "fused")
        before = instrument.get("hac.bwd_launches")
        grads[name] = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [xg, *hac.parameters()])
        assert instrument.get("hac.bwd_launches") == before + 2 * (name == "fused")
    needs = (True, False) + (True,) * (len(grads["plain"]) - 1)
    _grad_check_f64(hac, (grads["fused"][0], None, *grads["fused"][1:]),
                    (grads["plain"][0], None, *grads["plain"][1:]), x, None, rev, r, q, needs)


def test_fused_training_matches_levelwise_on_card(cuda):
    """Four steps of the flagship at batch 512 from one init and one noise
    stream: 4 launches per step, per-step loss within 1e-4 of 1+|loss|."""
    x = torch.randn((512, 100), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda) * 0.2
    losses = {}
    for impl in ("fused", "levelwise"):
        trainer = get_config(FLAGSHIP).make_trainer(impl=impl, device=cuda)
        state = trainer.init_state(0)
        gen = torch.Generator(device=cuda).manual_seed(5)
        before = instrument.get("hac.launches")
        losses[impl] = torch.stack([trainer.train_step(state, x, None, gen, 3e-4) for _ in range(4)]).sum(1)
        assert instrument.get("hac.launches") == before + (16 if impl == "fused" else 0)
    assert bool(torch.isfinite(losses["fused"]).all())
    d = (losses["fused"] - losses["levelwise"]).abs() / (1 + losses["levelwise"].abs())
    assert float(d.max()) <= 1e-4


def test_fused_recursive_cinn_training_matches_levelwise_on_card(cuda):
    """Four steps of a small condition-fed recursive_cinn (d=100, condition
    of 4, 2 blocks) at batch 512: 2 launches per step, per-step loss within
    1e-4 of 1+|loss|."""
    from hint_tpu_torch.models import builders
    from hint_tpu_torch.train.trainer import Trainer

    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((512, 100), generator=g, device=cuda) * 0.2
    y = torch.randn((512, 4), generator=g, device=cuda)
    losses = {}
    for impl in ("fused", "levelwise"):
        model = builders.recursive_cinn(100, 4, 2, (32, 16), impl=impl, device=cuda)
        trainer = Trainer(model=model, kind="cinn", batch_size=512, device=cuda)
        state = trainer.init_state(0)
        gen = torch.Generator(device=cuda).manual_seed(9)
        before = instrument.get("hac.launches")
        losses[impl] = torch.stack([trainer.train_step(state, x, y, gen, 3e-4) for _ in range(4)]).sum(1)
        assert instrument.get("hac.launches") == before + (8 if impl == "fused" else 0)
    assert bool(torch.isfinite(losses["fused"]).all())
    d = (losses["fused"] - losses["levelwise"]).abs() / (1 + losses["levelwise"].abs())
    assert float(d.max()) <= 1e-4


def test_reshuffle_block_runs_levelwise_on_card(cuda):
    """A block with per-node reshuffle (the first block of
    plus_shape.unconditional_hint_4_3_reshuffle) under impl="fused" runs the
    levelwise engine, as hint_tpu's fused_block does: no kernel launch, the
    same bits as impl="levelwise"."""
    kw = dict(dim=100, c_internal=(314, 157, 78, 39), max_splits=3, reshuffle=True)
    fused = HierarchicalAffineCoupling(impl="fused", **kw)
    fused.init(torch.Generator().manual_seed(0))
    plain = HierarchicalAffineCoupling(impl="levelwise", **kw)
    plain.load_state_dict(fused.state_dict())
    fused, plain = fused.to(cuda), plain.to(cuda)
    x = torch.randn((300, 100), generator=torch.Generator(device=cuda).manual_seed(12), device=cuda)
    before = (instrument.get("hac.launches"), instrument.get("hac.reshuffle_levelwise"))
    with torch.no_grad():
        for rev in (False, True):
            yf, lf = (fused.inverse if rev else fused)(x)
            yp, lp = (plain.inverse if rev else plain)(x)
            assert torch.equal(yf, yp) and torch.equal(lf, lp)
    assert (instrument.get("hac.launches"), instrument.get("hac.reshuffle_levelwise")) == (before[0], before[1] + 2)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kind", list(UCI_BLOCKS))
def test_uci_blocks_match_plain_on_card(cuda, kind, compute_dtype, tol):
    """The shallow UCI blocks (1-dimensional halves at the leaves): the
    forward kernel against the plain version at batch 37 and the config's
    batch, forward and inverse, and the backward kernels at batch 300."""
    dim, c_internal, batch = UCI_BLOCKS[kind]
    hac = _block(compute_dtype, cuda, c_internal=c_internal, dim=dim)
    g = torch.Generator(device=cuda).manual_seed(12)
    for b in (37, batch):
        x = torch.randn((b, dim), generator=g, device=cuda)
        for rev in (False, True):
            with torch.no_grad():
                before = instrument.get("hac.launches")
                yk, ldk = hac_fused.fused_block(hac, x, None, rev)
                assert instrument.get("hac.launches") == before + 1
                yp, ldp = hac_fused.plain_block(hac, x, None, rev)
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yp, rtol=tol, atol=tol)
            torch.testing.assert_close(ldk, ldp, rtol=tol, atol=tol)
    x, r = torch.randn((300, dim), generator=g, device=cuda), torch.randn((300, dim), generator=g, device=cuda)
    q = torch.randn((300,), generator=g, device=cuda)
    needs = (True, False, *(True,) * len(list(hac.parameters())))
    for rev in (False, True):
        saved = _saving_forward(hac, x, None, rev)
        before = instrument.get("hac.bwd_launches")
        k1 = hac_fused._run_block_grad(hac, saved, None, rev, r, q, needs)
        assert instrument.get("hac.bwd_launches") == before + 2
        plain = hac_fused.plain_block_grad(hac, x, None, rev, r, q, needs)
        if compute_dtype == "float32":
            _grad_check_f64(hac, k1, plain, x, None, rev, r, q, needs)
        else:
            assert _leaf_err(k1, plain) <= 2e-2


def test_quantile_abc_topk_on_card(cuda):
    """ABC's distances and top-k run where the pool lies: on the card its
    chunks' survivors are CUDA tensors, and the selection equals the CPU's
    (the same float32 distances, ties to the lower row)."""
    from hint_tpu_torch.evaluation import abc

    rng = np.random.default_rng(13)
    y = rng.standard_normal((200_000, 4)).astype(np.float32)
    y[1000:1040] = y[7]  # a tie across the boundary of the nearest rows
    target = y[7] + 0.01
    pool = torch.from_numpy(y).to(cuda)
    d, i = abc.chunk_topk(pool[:50_000], torch.from_numpy(target[None]).to(cuda), 102)
    assert d.device.type == i.device.type == "cuda" and d.dtype == torch.float32
    rows = np.arange(200_000)[:, None]
    got, thr = abc.quantile_ABC(rows, pool, target, n=1000, device_chunk=30_000)
    ref, ref_thr = abc.quantile_ABC(rows, y, target, n=1000, device_chunk=30_000, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert thr == ref_thr



def test_lens_sweep_on_card_matches_cpu(cuda):
    """The lens sweep's functions on the card against the same functions on
    the CPU, at the same draws: ring lengths, band, seam and i1 equal on the
    rows neither device flags, coordinates, x and features 1e-5 (f32 with
    other sin/cos and summation orders, as against hint_tpu)."""
    from hint_tpu_torch.data import lens_tpu

    g = torch.Generator().manual_seed(3)
    r0, theta = 1.0 + torch.rand(4096, generator=g), 2 * np.pi * torch.rand(4096, generator=g)
    shift = torch.randn(4096, 2, generator=g)
    cpu = lens_tpu._lens_rings_xy(r0, theta)
    dev = [t.cpu() for t in lens_tpu._lens_rings_xy(r0.to(cuda), theta.to(cuda))]
    live = (cpu[2] > 0) & (dev[2] > 0)
    assert live.sum() >= 4090
    torch.testing.assert_close(dev[2][live], cpu[2][live], rtol=0, atol=0)
    for a, b in zip(dev[:2], cpu[:2]):
        torch.testing.assert_close(a[live], b[live], rtol=0, atol=1e-5)
    x = lens_tpu._ring_to_x_xy(*cpu, shift)
    xd = lens_tpu._ring_to_x_xy(*(t.to(cuda) for t in cpu), shift.to(cuda)).cpu()
    torch.testing.assert_close(xd[live], x[live], rtol=0, atol=1e-5)
    f, band, seam, i1 = lens_tpu._forward_screen(x)
    fd, bandd, seamd, i1d = (t.cpu() for t in lens_tpu._forward_screen(x.to(cuda)))
    clear = ~band & ~bandd
    # a row whose top-two gap sits within the devices' rounding of the band
    # threshold may be flagged on one device only: the host decides it then
    assert (band != bandd).sum() <= 2
    assert torch.equal(seam[clear], seamd[clear]) and torch.equal(i1[clear], i1d[clear])
    torch.testing.assert_close(fd[clear], f[clear], rtol=0, atol=1e-5)


def test_plus_sweep_on_card_matches_cpu(cuda):
    from hint_tpu_torch.data import plus_tpu

    g = torch.Generator().manual_seed(4)
    u = torch.rand(7, 4096, generator=g)
    draws = (3 + 2 * u[0], 3 + 2 * u[1], 0.5 + 1.5 * u[2], 0.5 + 1.5 * u[3], -1.5 + 3 * u[4], -1.5 + 3 * u[5],
             0.5 * np.pi * u[6], 0.5 * torch.randn(4096, 2, generator=g))
    packed, params = plus_tpu._pipeline(*draws)
    packed_d, params_d = (t.cpu() for t in plus_tpu._pipeline(*(t.to(cuda) for t in draws)))
    assert torch.equal(params_d, params)
    flag = plus_tpu.FLAG_COLUMN
    clear = (packed[:, flag] == 0) & (packed_d[:, flag] == 0)
    assert clear.sum() >= 4090
    torch.testing.assert_close(packed_d[clear], packed[clear], rtol=0, atol=5e-5)


@pytest.mark.parametrize("family", ["lens", "plus"])
def test_sample_joint_on_card_is_deterministic_and_a_prefix(cuda, family):
    """The device sweep through pinned buffers and CUDA events: the same
    rows for any group, a smaller pool a prefix of a larger one."""
    from hint_tpu_torch.data import lens_tpu, plus_tpu

    mod = {"lens": lens_tpu, "plus": plus_tpu}[family]
    x, y = mod.sample_joint(10_000, seed=5, sub_batch=2048, group=3)
    assert np.isfinite(x).all() and np.isfinite(y).all() and x.dtype == y.dtype == np.float32
    for group in (1, 8):
        xs, ys = mod.sample_joint(5000, seed=5, sub_batch=2048, group=group)
        np.testing.assert_array_equal(xs, x[:5000])
        np.testing.assert_array_equal(ys, y[:5000])


def test_campaign_stage_train_counts_the_kernels_on_card(cuda, tmp_path, monkeypatch):
    """``campaign train --impl fused`` of the flagship cut to one epoch of
    two batches of 256: 4 forward launches per step and per evaluation
    batch, 2 backward launches per block and step, a finite train-log
    record, and its checkpoint sampled through ``make_samplers`` (one
    launch per block)."""
    import hint_tpu_torch.configs.registry_data as registry
    from hint_tpu_torch.experiments import campaign

    monkeypatch.setitem(registry.CONFIGS, FLAGSHIP, {**registry.CONFIGS[FLAGSHIP], "n_epochs": 1,
                                                     "max_batches_per_epoch": 2, "batch_size": 256,
                                                     "n_train": 512, "n_test": 256})
    monkeypatch.setattr(campaign, "CAMPAIGN_DIR", str(tmp_path / "campaign"))
    monkeypatch.chdir(tmp_path)
    before = instrument.snapshot()
    campaign.main(["train", "--family", "plus", "--configs", FLAGSHIP, "--seeds", "0", "--impl", "fused"])
    grown = instrument.since(before)
    counts = tuple(grown.get(k, 0) for k in ("hac.launches", "hac.launches.under_grad", "hac.bwd_launches",
                                             "hac.bwd_weight_launches"))
    assert counts == (4 * (2 + 1), 4 * 2, 2 * 4 * 2, 4 * 2)
    rec = campaign._read_log()[f"{FLAGSHIP}|s0|float32"]
    assert np.isfinite(rec["final_test_loss"]) and rec["n_epochs"] == 1
    before = instrument.get("hac.launches")
    sampler = campaign.make_samplers([FLAGSHIP], 0, impl="fused")[FLAGSHIP]
    x = sampler(np.random.default_rng(0).standard_normal((300, 100)).astype(np.float32))
    assert x.is_cuda and x.shape == (300, 100) and instrument.get("hac.launches") == before + 4


def _flagship_steps(mesh, x):
    """Four fused steps of the flagship over ``mesh`` (a rank of a spawned
    world): the losses, the parameters and the forward launches."""
    trainer = get_config(FLAGSHIP).make_trainer(mesh=mesh, impl="fused")
    state = trainer.init_state(0)
    gen = torch.Generator(device=mesh.device).manual_seed(5)
    before = instrument.get("hac.launches")
    x = x.to(mesh.device)
    losses = torch.stack([trainer.train_step(state, x, None, gen, 3e-4) for _ in range(4)])
    params = torch.cat([t.reshape(-1) for t in trainer.model.state_dict().values()])
    return losses.cpu().numpy(), params.cpu().numpy(), instrument.get("hac.launches") - before


def test_one_rank_nccl_world_is_the_single_process_on_card(cuda):
    """Four data-parallel steps of the flagship at batch 512 in a 1-rank
    NCCL world give the single process's losses and parameters bit for bit:
    an all-reduce over one rank is the identity."""
    from hint_tpu_torch.parallel.dryrun import spawn

    x = torch.randn((512, 100), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda) * 0.2
    trainer = get_config(FLAGSHIP).make_trainer(impl="fused", device=cuda)
    state = trainer.init_state(0)
    gen = torch.Generator(device=cuda).manual_seed(5)
    ref = torch.stack([trainer.train_step(state, x, None, gen, 3e-4) for _ in range(4)]).cpu().numpy()
    ref_params = torch.cat([t.reshape(-1) for t in trainer.model.state_dict().values()]).cpu().numpy()
    ((losses, params, launches),) = spawn(_flagship_steps, 1, x.cpu(), backend="nccl", timeout_s=120)
    assert launches == 16
    np.testing.assert_array_equal(losses, ref)
    np.testing.assert_array_equal(params, ref_params)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_bench_launches_every_kernel_each_step_on_card(cuda, compute_dtype):
    """The port's bench with ``impl="fused"``: 4 forward launches a step,
    all under autograd (in bf16 all by the wgmma route, in f32 all by the
    tiled route: the routes that save there), and 2 backward launches a
    block (4 of the weight kernel); none with ``impl="levelwise"``."""
    from hint_tpu_torch import bench

    steps = 2
    wg = 4 * (hac_fused._SAVE_ROUTE[compute_dtype] == hac_fused.ROUTE_WG)  # saving forwards by wgmma
    tiled = 4 * (hac_fused._SAVE_ROUTE[compute_dtype] == hac_fused.ROUTE_TILED)  # and by the tiled route
    for impl, want in (("fused", (4, 4, 8, 4, wg, tiled)), ("levelwise", (0, 0, 0, 0, 0, 0))):
        sps, launches = bench.bench_port(cuda, impl, compute_dtype, batch=512, steps=steps)
        assert sps > 0 and launches == {k: n * steps for k, n in zip(bench.LAUNCH_COUNTS, want)}


def test_entry_fused_matches_levelwise_and_a_second_dict_gets_its_own_pack_on_card(cuda):
    """``entry(impl="fused")`` within 1e-4 of ``impl="levelwise"`` on the
    flagship's 1,024 rows (4 launches); after the dict is freed, a second
    one of new tensors over its buffers (halved; each at a freed tensor's
    address and at version 0) gives its own loss, not the first's packed
    weights'."""
    from hint_tpu_torch.entry import entry

    fused, (params, x) = entry(cuda, "fused")
    plain, _ = entry(cuda)
    with torch.no_grad():
        for scale in (1.0, 0.5):
            if scale != 1.0:
                buffers = {k: torch.from_dlpack(v) for k, v in params.items()}  # their own version counters
                for v in buffers.values():
                    v.mul_(scale)
                addrs = {k: (v.data_ptr(), v._version) for k, v in params.items()}
                del params
                params = {k: torch.from_dlpack(v) for k, v in buffers.items()}
                assert {k: (v.data_ptr(), v._version) for k, v in params.items()} == addrs
            before = instrument.get("hac.launches")
            got = float(fused(params, x))
            assert instrument.get("hac.launches") == before + 4
            ref = float(plain(params, x))
            assert np.isfinite(got) and abs(got - ref) <= 1e-4 * (1 + abs(ref)), (scale, got, ref)
