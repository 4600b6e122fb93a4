"""Card-only tests of the port: the hac_block CUDA kernel against its plain
version, and the fused serving path against the levelwise one.

They need a CUDA card and skip without one (the kernel has no CPU mode);
this file imports no JAX so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_card.py -q

Tolerances: f32 1e-4 (the kernel sums each product in another order than
the plain version's matmuls, through 7 levels of exp-scaled couplings);
bf16 2e-2 (both round the same activations to bf16, but an activation on a
rounding boundary can land one bf16 ulp apart).
"""

import numpy as np
import pytest
import torch

from hint_tpu_torch.configs import get_config
from hint_tpu_torch.convert import params_to_numpy
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.serve import InferenceService

FLAGSHIP = "plus_shape.unconditional_hint_4_full"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hac_block kernel has no CPU mode")
    return torch.device("cuda")


def _block(compute_dtype, device):
    """Flagship HAC block from model.init, noise in every padded entry."""
    hac = HierarchicalAffineCoupling(
        dim=100, c_internal=(263, 131, 65, 32, 32), compute_dtype=compute_dtype, impl="fused"
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
                before = hac_fused.launches
                yk, ldk = hac_fused.fused_block(hac, x, None, rev)
                assert hac_fused.launches == before + 1
                yp, ldp = hac_fused.plain_block(hac, x, None, rev)
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yp, rtol=tol, atol=tol)
            torch.testing.assert_close(ldk, ldp, rtol=tol, atol=tol)


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
