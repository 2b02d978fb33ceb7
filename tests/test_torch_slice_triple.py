"""The K5 triple slicer (sfft_tpu_torch/core/slicing.py slice_triple) against
sfft_tpu.core.exact_fft._slice_triple_real.

Inputs are made from seeds with numpy and fed to both packages. sfft_tpu
runs jitted on the CPU, where its Pallas slicer is off, so its XLA chain is
the reference (tests/test_exact_fft.py holds the Pallas kernel to that chain
in interpret mode). The plain twin must match it bit for bit, slices and
scales. The reference is imported inside the tests, so the `gpu` cases,
which hold the CUDA kernel to its twin on the card, also run where jax is
absent (``pytest --noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import exact_fft as tef
from sfft_tpu_torch.core import slicing as tsl

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)


def _triple_parts(v):
    """Exact three-way f32 split of an f64 array."""
    hi = v.astype(np.float32)
    rem = v - hi.astype(np.float64)
    mid = rem.astype(np.float32)
    return hi, mid, (rem - mid.astype(np.float64)).astype(np.float32)


def _wide_range(seed, shape, zero_rows=()):
    """Values over ~14 decades, with the named rows all zero."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 7.3, shape) * np.exp(rng.normal(0, 4, shape))
    for r in zero_rows:
        v[r] = 0.0
    return v


def _tt(parts, device="cpu"):
    return [torch.as_tensor(p, device=device) for p in parts]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CASES = [((37, 53), (5, 36)), ((3, 16, 40), ()), ((131,), ())]


@pytest.mark.parametrize("nsl", [8, 12])
@pytest.mark.parametrize("rowwise", [True, False])
@pytest.mark.parametrize("shape,zero_rows", CASES)
def test_slice_triple_bit_identical_to_reference(shape, zero_rows, rowwise, nsl):
    import jax
    import jax.numpy as jnp
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import exact_fft as jef

    parts = _triple_parts(_wide_range(11, shape, zero_rows))
    ref_sl, ref_s = jax.jit(lambda h, m, l: jef._slice_triple_real(h, m, l, nsl, rowwise))(
        *(jnp.asarray(p) for p in parts))
    sl, s = tef._slice_triple_real(*_tt(parts), nsl, rowwise)
    assert sl.dtype == torch.int8 and tuple(sl.shape) == (nsl,) + shape
    np.testing.assert_array_equal(sl.numpy(), np.asarray(ref_sl))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    if zero_rows and rowwise:
        assert not sl[:, list(zero_rows)].any()


@pytest.mark.parametrize("rowwise", [True, False])
def test_slice_triple_captures_72_bits(rowwise):
    """12 slices hold the value to 2^-72 of the scale (a pair floors at
    2^-48); the TwoSum carry at slice 4 is what keeps the low 24 bits."""
    v = _wide_range(12, (29, 45))
    sl, s = tef._slice_triple_real(*_tt(_triple_parts(v)), 12, rowwise)
    rep = sum(sl[q].double() * 2.0 ** (-6 * (q + 1)) for q in range(12)) * s.double()
    err = ((rep - torch.as_tensor(v)) / s.double()).abs().max()
    assert float(err) <= 2.0 ** -70


def test_slice_triple_pads_output_columns():
    parts = _tt(_triple_parts(_wide_range(13, (6, 13))))
    plain, s = tef._slice_triple_real(*parts, 12, True)
    padded, s2 = tef._slice_triple_real(*parts, 12, True, out_cols=16)
    assert tuple(padded.shape) == (12, 6, 16) and torch.equal(s, s2)
    assert torch.equal(padded[..., :13], plain) and not padded[..., 13:].any()


def test_slice_triple_refusals():
    hi = torch.ones((4, 8))
    s = torch.ones(())
    with pytest.raises(TypeError):
        tsl.slice_triple(hi.double(), hi.double(), hi.double(), s.double(), 12)
    with pytest.raises(ValueError):
        tsl.slice_triple(hi, hi, hi[:, :4], s, 12)                  # shapes differ
    with pytest.raises(ValueError):
        tsl.slice_triple(hi, hi, hi, torch.ones((4,)), 12)          # scale neither () nor (4, 1)
    with pytest.raises(ValueError):
        tsl.slice_triple(hi.T, hi.T, hi.T, s, 12)                   # non-contiguous
    with pytest.raises(ValueError):
        tsl.slice_triple(hi, hi, hi, s, 7)                          # injections would be lost
    with pytest.raises(ValueError):
        tsl.slice_triple(hi, hi, hi, s, 12, out_cols=7)             # narrower than the data
    assert tsl.TRIPLE_NSL_MIN == 8


GPU_CASES = [((512, 1207), True, 1208), ((13207,), False, 13208), ((64, 384), True, None),
             ((64, 384), False, 392), ((37, 53), True, 53), ((3, 40, 130), True, 136)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,rowwise,out_cols", GPU_CASES)
def test_slice_triple_kernel_bit_identical_to_twin_on_gpu(cuda, shape, rowwise, out_cols):
    v = _wide_range(14, shape, zero_rows=(1,) if len(shape) > 1 else ())
    parts = _tt(_triple_parts(v), cuda)
    for nsl in (8, 12):
        before = tsl.slice_triple.launches
        sl, s = tef._slice_triple_real(*parts, nsl, rowwise, out_cols=out_cols)
        torch.cuda.synchronize()
        assert tsl.slice_triple.launches == before + 1
        ref, s_ref = tef._slice_triple_real(*parts, nsl, rowwise, plain=True, out_cols=out_cols)
        assert torch.equal(sl, ref) and torch.equal(s, s_ref)
    # views that start off the 16-byte boundary take the scalar loads
    off = [p.reshape(-1)[1:] for p in parts]
    sl, _ = tef._slice_triple_real(*off, 12, False)
    ref, _ = tef._slice_triple_real(*off, 12, False, plain=True)
    assert torch.equal(sl, ref)
