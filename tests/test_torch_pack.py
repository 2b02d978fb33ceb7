"""The int16 upload of the fast survey path (utils/pack.py,
parallel/batch.upload_packed / batched_subtract_packed, the scheduler's
prefetch and mesh-batched groups) against sfft_tpu's, on the CPU.

pack_i16 is the same numpy code as sfft_tpu's and unpack_i16 the same
operations (an f32 multiply, the sentinel to NaN, the cast), so both are
held bit for bit, with NaN and +-inf pixels and zero blocks. The scheduler
quantizes exactly the configs sfft_tpu quantizes (``_pack_eligible``: the
fast modes), and both packages hand the engine the same planes; contract
and exact-solver configs stay unpacked.
"""

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax.numpy as jnp
from sfft_tpu.parallel import batch as jbatch
from sfft_tpu.parallel import scheduler as jsched
from sfft_tpu.utils import pack as jpack

from sfft_tpu_torch.parallel import batch as tbatch
from sfft_tpu_torch.parallel import scheduler as tsched
from sfft_tpu_torch.utils import pack as tpack

from test_torch_engine import cfgs, make_pair

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

FAST = dict(greek_backend="peeled", fdiff_backend="fft32", solver="refined")
CONTRACT = dict(greek_backend="pexact", fdiff_backend="pexact", solver="exact")


def _plane(seed, shape=(150, 70)):
    """Values over six decades, NaN and +-inf pixels, a zero block and a
    ragged last block."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, shape) * 10.0 ** rng.integers(-3, 4, shape)
    a[64:128] = 0.0
    a[3, 5] = np.nan
    a[10, 0] = np.inf
    a[140, 69] = -np.inf
    return a


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("block", [64, 32])
def test_pack_i16_bit_for_bit(block):
    a = _plane(1)
    tp, jp = tpack.pack_i16(a, block), jpack.pack_i16(a, block)
    _bits_equal(tp.q, jp.q)
    _bits_equal(tp.scales, jp.scales)
    assert (tp.n0, tp.block) == (jp.n0, jp.block) == (150, block)
    assert (tp.q == -32768).sum() == 3 and np.all(tp.scales[64 // block] == 1.0)
    stack = np.stack([_plane(2), _plane(3)])
    for t, j in zip(tpack.pack_stack_i16(stack, block), jpack.pack_stack_i16(stack, block)):
        _bits_equal(t, j)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_unpack_i16_bit_for_bit(dtype):
    pk = tpack.pack_i16(_plane(4))
    out = tpack.unpack_i16(torch.as_tensor(pk.q), torch.as_tensor(pk.scales), pk.n0, pk.block,
                           dtype)
    ref = jpack.unpack_i16(jnp.asarray(pk.q), jnp.asarray(pk.scales), pk.n0, pk.block,
                           jnp.float64 if dtype == torch.float64 else jnp.float32)
    _bits_equal(out.numpy(), ref)
    assert out.dtype == dtype and int(out.isnan().sum()) == 3
    assert tpack.unpack_i16(torch.as_tensor(pk.q), torch.as_tensor(pk.scales), pk.n0,
                            pk.block).dtype == torch.float64


def _prep(cfg, seed):
    I, J = make_pair(seed, 40, 36)
    mI, mJ = I.copy(), J.copy()
    mI[5:9, 7:12] = 0.0
    return {"cfg": cfg, "PixA_I": np.asfortranarray(I), "PixA_J": J, "PixA_mI": mI,
            "PixA_mJ": mJ, "other": 7}


@pytest.mark.parametrize("backends,packed", [(FAST, True), (dict(FAST, greek_backend="fft32"),
                                                             True),
                                             (CONTRACT, False), (dict(FAST, solver="exact"),
                                                                 False)])
def test_prefetch_quantizes_as_reference(backends, packed):
    jc, tc = cfgs(N0=40, N1=36, **backends)
    assert tsched._pack_eligible(tc) == jsched._pack_eligible(jc) == packed
    ref = jsched._prefetch_pair_planes(_prep(jc, 5))
    out = tsched._prefetch_pair_planes(_prep(tc, 5))
    raw = _prep(tc, 5)
    for k in tsched._PLANES:
        if packed:
            _bits_equal(out[k].numpy(), ref[k])
            assert not np.array_equal(out[k].numpy(), raw[k])
        else:   # unpacked: the port leaves CPU planes as they are
            assert out[k] is not None and np.array_equal(np.asarray(out[k]), raw[k])
            _bits_equal(np.asarray(ref[k]), raw[k])
    assert out["other"] == 7 and out.get("h2d_event") is None


def test_batched_subtract_packed_equals_batched_subtract_on_dequantized_planes():
    _, tc = cfgs(N0=40, N1=36, w=1, **FAST)
    preps = [_prep(tc, 6), _prep(tc, 7)]
    stacks = [[p[k] for p in preps] for k in tsched._PLANES]
    out = tbatch.batched_subtract_packed(*stacks, tc, devices=["cpu"])

    def deq(a):
        pk = tpack.pack_i16(np.ascontiguousarray(a, np.float32))
        return tpack.unpack_i16(torch.as_tensor(pk.q), torch.as_tensor(pk.scales), pk.n0,
                                pk.block)

    ref = tbatch.batched_subtract(*([deq(a) for a in s] for s in stacks), tc, devices=["cpu"])
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    planes, event = tbatch.upload_packed([stacks[0][0], stacks[0][0]], "cpu")
    assert event is None and planes[0] is planes[1] and planes[0].is_contiguous()


@pytest.mark.parametrize("backends,pack_h2d,packed", [(FAST, "auto", True), (FAST, "off", False),
                                                      (CONTRACT, "auto", False)])
def test_mesh_batched_groups_quantize_as_reference(monkeypatch, backends, pack_h2d, packed):
    """run_mesh_batched over two devices on two same-config tasks: the planes
    that reach the batched step are sfft_tpu's, int16-dequantized for the
    fast config under PACK_H2D='auto', the f64 planes otherwise."""
    jc, tc = cfgs(N0=40, N1=36, **backends)
    seen = {}

    def record(tag):
        def fake(*args):
            planes = [np.stack([np.asarray(p) for p in s]) for s in args[:4]]
            seen[tag] = planes
            B = len(planes[0])
            return np.zeros((B, 3)), np.zeros((B, 40, 36)), np.zeros(B)
        return fake

    def fake_packed_fn(cfg, mesh, n0, blk):
        # sfft_tpu's packed step: the int16 stacks and scales, unpacked as its jit does
        return lambda *a: record("j")(*([jpack.unpack_i16(a[2 * k][b], a[2 * k + 1][b], n0, blk)
                                         for b in range(len(a[0]))] for k in range(4)))

    monkeypatch.setattr(jbatch, "batched_subtract", lambda *a: record("j")(*a[:4]))
    monkeypatch.setattr(jbatch, "_batched_packed_fn", fake_packed_fn)
    monkeypatch.setattr(tbatch, "batched_subtract", lambda *a, **k: record("t")(*a[:4]))
    for tag, mod, cfg, where in (("j", jsched, jc, {"mesh": jbatch.make_data_mesh(2)}),
                                 ("t", tsched, tc, {"devices": ["cpu", "cpu"]})):
        preps = {t: _prep(cfg, 8 + t) for t in range(2)}
        status, _ = mod.run_mesh_batched(
            2, lambda tid: preps[tid], lambda tid, prep, precomputed=None: precomputed is not None,
            lambda prep: (prep["cfg"],) + tuple(prep[k] for k in tsched._PLANES) + (True,),
            NUM_THREADS_4PREPROC=1, VERBOSE_LEVEL=0, PACK_H2D=pack_h2d, **where)
        assert status == {0: 2, 1: 2}
    raw = [np.stack([_prep(tc, 8 + t)[k] for t in range(2)]) for k in tsched._PLANES]
    for t, j, r in zip(seen["t"], seen["j"], raw):
        _bits_equal(t, j)
        assert np.array_equal(t, r) != packed
