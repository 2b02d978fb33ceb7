"""K3 (the skinny f64 moment contraction) and its plain twin.

On the CPU, sfft_tpu_torch.core.moments.moments runs its plain twin (W @ G
in f64); it is held to numpy f64 and to sfft_tpu's Pallas kernel in
interpret mode, at the shapes of tests/test_pallas_moments.py. The CUDA
kernel is held to the twin on the card by the `gpu`-marked case (and by
chip_smoke.py). The reference is imported inside the tests, so the `gpu`
cases also run where jax is absent (``pytest --noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import moments as tmom

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

SHAPES = [(3, 300, 257), (16, 512, 130), (20, 256, 129)]


def _inputs(S, N0, N1, seed=5):
    # smooth + rough content with a large dynamic range (the inputs of
    # tests/test_pallas_moments.py)
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1, (S, N0)) * np.logspace(0, 6, N0)[None, :]
    G = rng.normal(0, 1, (N0, N1)) + 1e4
    return W, G


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("S,N0,N1", SHAPES)
def test_plain_moments_match_numpy_f64(S, N0, N1):
    W, G = _inputs(S, N0, N1)
    out = tmom.moments(torch.as_tensor(W), torch.as_tensor(G))
    ref = W @ G
    assert out.dtype == torch.float64 and out.shape == (S, N1)
    # both are f64 dot products of N0 terms, summed in another order
    rel = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= 1e-14, rel


@pytest.mark.parametrize("S,N0,N1", SHAPES)
def test_moments_match_pallas_interpret(S, N0, N1):
    import jax.numpy as jnp
    from sfft_tpu.core.pallas_moments import moments_pallas

    W, G = _inputs(S, N0, N1)
    ref = np.asarray(moments_pallas(jnp.asarray(W), jnp.asarray(G), bx=128, by=128,
                                    interpret=True))
    out = tmom.moments(torch.as_tensor(W), torch.as_tensor(G)).numpy()
    # the bound of test_pallas_moments.py: interpret mode loses part of the
    # double-float compensation (~1e-8), the f64 twin is exact to ~1e-16
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("S", [17, 37])
def test_moments_chunk_rows_beyond_16(S):
    W, G = _inputs(S, 200, 70, seed=9)
    launches = tmom.moments.launches
    out = tmom.moments(torch.as_tensor(W), torch.as_tensor(G)).numpy()
    ref = W @ G
    assert out.shape == (S, 70)
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-14
    # the CPU twin launches nothing
    assert tmom.moments.launches == launches


def test_moments_refusals():
    W = torch.ones((4, 32), dtype=torch.float64)
    G = torch.ones((32, 16), dtype=torch.float64)
    with pytest.raises(TypeError):
        tmom.moments(W.float(), G)
    with pytest.raises(TypeError):
        tmom.moments(W, G.float())
    with pytest.raises(ValueError):
        tmom.moments(W, torch.ones((16, 32), dtype=torch.float64).T)  # non-contiguous
    with pytest.raises(ValueError):
        tmom.moments(W[:, ::2], G[:16])                                # non-contiguous
    with pytest.raises(ValueError):
        tmom.moments(W, G[:31])                                        # shape mismatch
    with pytest.raises(ValueError):
        tmom.moments(W[0], G)                                          # not 2-D


def test_moments_empty_extents():
    out = tmom.moments(torch.ones((3, 0), dtype=torch.float64),
                       torch.ones((0, 5), dtype=torch.float64))
    assert out.shape == (3, 5) and float(out.abs().max()) == 0.0


@pytest.mark.parametrize("N0,N1", [(4096, 4096), (300, 257), (64, 1), (1, 4096), (100000, 8)])
def test_split_plan_covers_contraction(N0, N1):
    nsplit, rows = tmom._split_plan(N0, N1)
    assert rows % tmom._ROW_TILE == 0 and rows > 0
    assert nsplit * rows >= N0 and (nsplit - 1) * rows < N0
    assert 1 <= nsplit <= 65535


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("N0,N1", [(4096, 4096), (300, 257), (512, 130), (7, 300), (1, 1),
                                   (3001, 20001), (3001, 20002), (100000, 8), (5000000, 2)])
def test_launch_plan_covers_every_block_once(N0, N1, aligned):
    """Every (column block, row range) of the kernel's grid: the column
    blocks tile [0, N1) and the row ranges tile [0, N0), each exactly once
    and none empty; 16-byte loads only where every row stays aligned."""
    plan = tmom._launch_plan(N0, N1, aligned=aligned)
    assert plan["vec"] == (2 if aligned and N1 % 2 == 0 else 1)
    assert plan["cols"] == tmom._COLS // 2 * plan["vec"]
    col_edges = [(i * plan["cols"], min(N1, (i + 1) * plan["cols"]))
                 for i in range(plan["col_blocks"])]
    row_edges = [(k * plan["rows"], min(N0, (k + 1) * plan["rows"]))
                 for k in range(plan["nsplit"])]
    for edges, n in ((col_edges, N1), (row_edges, N0)):
        assert edges[0][0] == 0 and edges[-1][1] == n
        assert all(lo < hi for lo, hi in edges)
        assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    assert plan["nsplit"] <= 65535 and plan["rows"] % tmom._ROW_TILE == 0
    # a full-size grid is about one even wave; never far beyond the target
    assert plan["col_blocks"] * plan["nsplit"] <= max(plan["col_blocks"], tmom._TARGET_BLOCKS)


def test_launch_plan_sweep_shapes():
    """Over a sweep of square image shapes the full-width plan is the
    kernel's one block shape (128 columns, whole 16-row tiles) in a grid of
    at most one wave of the target."""
    for n in (512, 1024, 2048, 4096, 8192):
        plan = tmom._launch_plan(n, n)
        assert (plan["vec"], plan["cols"]) == (2, tmom._COLS)
        assert plan["rows"] % tmom._ROW_TILE == 0
        assert plan["col_blocks"] * plan["nsplit"] <= tmom._TARGET_BLOCKS
    assert tmom._launch_plan(4096, 4096)["nsplit"] == tmom._TARGET_BLOCKS // 32


def test_peel_routes_f64_products_through_moments():
    from sfft_tpu_torch.core.peel import _exact_skinny_matmul

    W, G = _inputs(8, 128, 96)
    Wt, Gt = torch.as_tensor(W), torch.as_tensor(G)
    np.testing.assert_allclose(_exact_skinny_matmul(Wt, Gt).numpy(), W @ G, rtol=1e-14)
    np.testing.assert_allclose(_exact_skinny_matmul(Wt, Gt, plain=True).numpy(), W @ G,
                               rtol=1e-14)
    # f32 operands take the plain product (as in sfft_tpu)
    out32 = _exact_skinny_matmul(Wt.float(), Gt.float())
    assert out32.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("S,N0,N1", SHAPES + [(8, 4096, 4096)])
def test_moments_kernel_matches_twin_on_gpu(cuda, S, N0, N1):
    W, G = _inputs(S, N0, N1)
    Wd = torch.as_tensor(W, device=cuda)
    Gd = torch.as_tensor(G, device=cuda)
    before = tmom.moments.launches
    out = tmom.moments(Wd, Gd)
    torch.cuda.synchronize()
    assert tmom.moments.launches == before + -(-S // 16)
    ref = tmom.moments_plain(Wd, Gd)
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-13, rel


@pytest.mark.gpu
@pytest.mark.parametrize("S,N0,N1,shift", [
    (3, 7, 300, 0),          # one split: no reduction pass
    (8, 500, 384, 1),        # even N1, 8 bytes off the 16-byte boundary: 8-byte loads
    (5, 3001, 20001, 0),     # odd N1, several W chunks per block
    (5, 3001, 20002, 0),     # 16-byte loads, ragged last column block
    (16, 100000, 8, 0),      # one column block, many splits
])
def test_moments_kernel_ragged_and_deterministic_on_gpu(cuda, S, N0, N1, shift):
    rng = np.random.default_rng(3)
    W = torch.as_tensor(rng.normal(0, 1, (S, N0)), device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    G = torch.randn((N0 * N1 + shift,), dtype=torch.float64, device=cuda, generator=g)
    G = (G + 100.0)[shift:].reshape(N0, N1)
    out = tmom.moments(W, G)
    again = tmom.moments(W, G)
    torch.cuda.synchronize()
    assert torch.equal(out, again)           # fixed summation order
    ref = tmom.moments_plain(W, G)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-13


@pytest.mark.gpu
def test_moments_kernel_on_side_stream_on_gpu(cuda):
    W, G = _inputs(8, 1024, 640)
    Wd, Gd = torch.as_tensor(W, device=cuda), torch.as_tensor(G, device=cuda)
    ref = tmom.moments_plain(Wd, Gd)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        outs = [tmom.moments(Wd, Gd) for _ in range(3)]
    main = tmom.moments(Wd, Gd)             # the default stream has tickets of its own
    side.synchronize()
    torch.cuda.synchronize()
    for out in outs + [main]:
        assert torch.equal(out, outs[0])
        assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-13


@pytest.mark.gpu
def test_moments_refusals_on_gpu(cuda):
    W = torch.ones((4, 32), dtype=torch.float64, device=cuda)
    G = torch.ones((32, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tmom.moments(W.float(), G)
    with pytest.raises(ValueError):
        tmom.moments(W, G.T.contiguous().T)      # non-contiguous
    with pytest.raises(ValueError):
        tmom.moments(W, G.cpu())                 # two devices
    with pytest.raises(ValueError):
        tmom.moments(W, G[:31])
