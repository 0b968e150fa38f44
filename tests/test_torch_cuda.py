"""On-card tests of the port's CUDA kernels (marker ``cuda``; they skip on
a machine without a GPU). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.device import full_f32_matmul
    full_f32_matmul()
    return torch.device("cuda")


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=3e-5, atol=3e-4))


@pytest.mark.parametrize("k,d", [(1, 1), (3, 511), (100, 8070),
                                 (1000, 8070)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_payload", [False, True])
def test_round_stats_kernel_matches_twin(cuda, k, d, dtype, with_payload):
    from repro_torch.kernels import round_stats as rs
    gen = torch.Generator(device=cuda).manual_seed(k * d)
    x = torch.randn((k, d), generator=gen, device=cuda).to(dtype)
    g = torch.randn((d,), generator=gen, device=cuda)
    p = (torch.randn((k, d), generator=gen, device=cuda).to(dtype)
         if with_payload else None)
    before = rs.launches
    got, got_g = rs.round_stats_cuda(x, g, p)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    want, want_g = rs.round_stats_plain(x, g, p)
    torch.testing.assert_close(got, want, **_tol(dtype))
    torch.testing.assert_close(got_g, want_g, rtol=3e-5, atol=0.0)


@pytest.mark.parametrize("k,d", [(1, 1), (3, 511), (100, 8070),
                                 (1000, 8070)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["zero", "partial", "full"])
def test_superpose_kernel_matches_twin(cuda, k, d, dtype, mask_kind):
    from repro_torch.kernels import aircomp_sum as ac
    gen = torch.Generator(device=cuda).manual_seed(k + d)
    x = torch.randn((k, d), generator=gen, device=cuda).to(dtype)
    p = 0.1 + 15.0 * torch.rand((k,), generator=gen, device=cuda)
    m = {"zero": torch.zeros((k,), device=cuda),
         "full": torch.ones((k,), device=cuda),
         "partial": (torch.rand((k,), generator=gen, device=cuda)
                     < 0.5).float()}[mask_kind]
    n = 1e-3 * torch.randn((d,), generator=gen, device=cuda)
    got, raw = ac.superpose_normalize_cuda(x, p, m, n)
    torch.cuda.synchronize()
    want, want_raw = ac.superpose_normalize_plain(x, p, m, n)
    tol = _tol(dtype) if dtype == torch.bfloat16 else dict(rtol=3e-5,
                                                           atol=3e-5)
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(raw, want_raw, rtol=3e-5, atol=0.0)
    if mask_kind == "zero":
        assert float(raw) == 0.0


def test_kernels_are_deterministic(cuda):
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    x = torch.randn((1000, 8070), device=cuda)
    g = torch.randn((8070,), device=cuda)
    p, m = torch.rand((1000,), device=cuda), torch.ones((1000,), device=cuda)
    a = [rs.round_stats_cuda(x, g, x)[0] for _ in range(3)]
    b = [ac.superpose_normalize_cuda(x, p, m, g)[0] for _ in range(3)]
    for r in a[1:]:
        assert torch.equal(r, a[0])
    for r in b[1:]:
        assert torch.equal(r, b[0])


def _server(transmit="model"):
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import partition_noniid
    from repro_torch.data.pipeline import build_federation
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.fl import FLClient, FusedPAOTA, PAOTAConfig
    from repro_torch.models.mlp import init_mlp_params, mlp_loss
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    parts = partition_noniid(y, n_clients=8, seed=0)
    clients = [FLClient(d, mlp_loss, 32, 0.1, 5)
               for d in build_federation(x, y, parts)]
    return FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(),
                      SchedulerConfig(n_clients=8, seed=1),
                      PAOTAConfig(transmit=transmit))


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_fused_round_runs_through_both_kernels(cuda, transmit):
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    drv = _server(transmit)
    rs.launches = ac.launches = 0
    rows = drv.advance(10)
    assert (rs.launches, ac.launches) == (10, 10)
    assert np.isfinite(drv.global_vec).all()
    assert any(r["n_participants"] > 0 for r in rows)


def test_rounds_make_no_host_sync(cuda):
    """Between stages a round reads nothing back to the host: three rounds
    of scan_rounds run with torch's sync debug mode set to error."""
    from repro_torch.fl.runtime import scan_rounds
    drv = _server()
    drv.advance(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            scan_rounds(drv._carry, 3, rcfg=drv._rcfg, streams=drv._streams)
    finally:
        torch.cuda.set_sync_debug_mode("default")
