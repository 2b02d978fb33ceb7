"""K6, the exact paths' f32 pair products (sfft_tpu_torch/core/pairs.py and
csrc/pair_products.cu, pair_model.cu, pair_poly.cu), and their plain twins.

On the CPU:

  * the twins against sfft_tpu, jitted, on the same numpy-seeded inputs:
    _pair_hadamard_conj, _pair_mul_static, _pair_mul_static_rr (broadcast
    tables of shape (N0, 1), (1, N1) and ()), pair_sep_mul, the row
    weighting of both lanes of a complex pair, and pexact's
    pair_poly_plane, within 1e-13 of their maximum (the bound
    tests/test_torch_exact_fft.py holds pair results to);
  * rr's and scale_pair's orders of addition against a numpy emulation in
    f32, bit for bit, on inputs where the two orders differ;
  * the factored model spectrum (pair_model_spectrum_plain) bit for bit
    against the inline loops of fdiff_exact and fdiff_pexact that it
    replaced (copied below), ENTANGLED (Fij 6) and SEPARATE-VARYING with a
    B-spline Fij (25) and scaling planes (6);
  * K6a's launch plan (collapsed axes, broadcast strides, plane pointers,
    mode) emulated in numpy: the operands it gathers, run through the twin,
    give the twin's bits;
  * K6p's fused modes: the twins of ``pair_poly_sub`` and
    ``pair_poly_add64`` bit for bit against the chains pexact ran before
    them (copied below), row-major and transposed, on wide-range and edge
    values; each against sfft_tpu's chain (pair_sub(pair_from_f64(I),
    pair_poly_plane(C)) and fdiff_pexact's f64 materialisation) within
    1e-13 of max;
  * the dispatch: with the kernel wrappers replaced by stubs and the twins
    refusing calls from anywhere else, the pexact and the v2 exact path run
    every pair product through the wrappers (plain=False; the polynomial
    planes through the fused K6p modes, never the plane mode) and none with
    plain=True;
  * refusals: complex input where a real pair is required, shapes that do
    not broadcast, wrong types and inconsistent model shapes; K6p's wrong
    dtypes, shapes, devices and layouts.

The `gpu` cases hold each kernel mode to its twin on the card with
torch.equal, on strided and offset views, +-0, subnormal lo parts and
magnitudes near 2^+-60; K6p's three modes at SP 1, 4 and 6 on widths that
are not a multiple of its 128-column tile, odd widths, transposed inputs
and 4096^2. The reference is imported inside the CPU tests, so
they also run where jax is absent (``pytest --noconftest -m gpu``).
"""

import types

import numpy as np
import pytest
import torch

from sfft_tpu_torch.core import exact_fft as tef
from sfft_tpu_torch.core import pairs
from sfft_tpu_torch.core.statics import Static

# the suite runs in several worker processes on one CPU: two threads each
torch.set_num_threads(2)

TOL = 1e-13     # of max|reference|, tests/test_torch_exact_fft.py's pair bound


def _jef():
    import sfft_tpu  # noqa: F401  (x64)
    from sfft_tpu.core import exact_fft

    return exact_fft


def _split(x):
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def _cpair(shape, seed, real=False):
    """A seeded pair operand (numpy planes) over ~8 decades."""
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(1 if real else 2):
        planes += _split(rng.normal(size=shape) * 10.0 ** rng.uniform(-4, 4, size=shape))
    return planes + [None] * (4 - len(planes))


def _t(planes, dev="cpu"):
    return pairs.CPair(*(None if v is None else torch.as_tensor(v, device=dev) for v in planes))


def _c128(p):
    return tef.pair_to_c128(p).numpy()


def _table(seed, shape, kind):
    """A seeded static table: complex ('c') or real."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, size=shape)
    return W + 1j * rng.normal(size=shape) if kind == "c" else W


def _close(out, ref):
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def test_twins_match_reference():
    import jax

    jef = _jef()
    A, B = _cpair((3, 20, 17), 1), _cpair((3, 20, 17), 2)
    ref = jax.jit(lambda a, b: jef._pair_hadamard_conj(jef.CPair(*a), jef.CPair(*b)))(A, B)
    _close(_c128(tef._pair_hadamard_conj(_t(A), _t(B))), np.asarray(jef.pair_to_c128(ref)))

    W = Static(_table, (3, (8, 12), "c"))
    v = _cpair((4, 8, 12), 4)
    ref = jax.jit(lambda a: jef._pair_mul_static(jef.CPair(*a), W.host()))(v)
    _close(_c128(tef._pair_mul_static(_t(v), W)), np.asarray(jef.pair_to_c128(ref)))

    # a real pair times real tables broadcast as (N0, 1), (1, N1) and ()
    x = _cpair((16, 12), 5, real=True)
    for shape in [(16, 1), (1, 12), ()]:
        W = Static(_table, (6, shape, "r"))
        ref = jax.jit(lambda a: jef._pair_mul_static_rr(jef.CPair(*a), W.host()))(x)
        _close(_c128(tef._pair_mul_static_rr(_t(x), W)), np.asarray(jef.pair_to_c128(ref)))

    u, w = Static(_table, (7, (16, 1), "r")), Static(_table, (8, (1, 12), "r"))
    ref = jax.jit(lambda a: jef.pair_sep_mul(jef.CPair(*a), u.host()[:, 0], w.host()[0]))(x)
    _close(_c128(tef.pair_sep_mul(_t(x), u, w)), np.asarray(jef.pair_to_c128(ref)))

    # the row weighting: both lanes of a complex pair by one real factor
    # (sfft_tpu's exact_sep_weighted_spectra applies _pair_mul_static_rr's
    # arithmetic to each lane)
    z = _cpair((16, 9), 9)
    U = Static(_table, (10, (16, 1), "r"))
    got = pairs.pair_products("mul_static_rr", _t(z), pairs.CPair(*tef._split_on(U, "cpu"),
                                                                  None, None))
    for lane, (h, l) in enumerate([(z[0], z[1]), (z[2], z[3])]):
        ref = jax.jit(lambda a, b: jef._pair_mul_static_rr(jef.CPair(a, b, None, None),
                                                           U.host()))(h, l)
        g = got[2 * lane].double() + got[2 * lane + 1]
        _close(g.numpy(), np.asarray(ref.rh, np.float64) + np.asarray(ref.rl))


def test_pair_poly_plane_matches_reference():
    import jax
    import jax.numpy as jnp
    from sfft_tpu.core import pexact as jpexact

    from sfft_tpu_torch.core import pexact as tpexact

    rng = np.random.default_rng(11)
    for SP, N0, N1 in [(6, 48, 40), (1, 9, 7)]:
        C = rng.normal(size=(SP, SP)) * 10.0 ** rng.uniform(-3, 3, size=(SP, SP))
        ref = jax.jit(lambda c: jpexact.pair_poly_plane(c, N0, N1))(jnp.asarray(C))
        before = pairs.pair_poly.launches
        got = tpexact.pair_poly_plane(torch.as_tensor(C), N0, N1)
        assert pairs.pair_poly.launches == before       # the CPU twin launches nothing
        _close(_c128(got), np.asarray(ref.rh, np.float64) + np.asarray(ref.rl))


# --- K6p's fused modes: the chains pexact ran before them (core/pexact.py
# pexact_plane_spectra and fdiff_pexact), for the bit-for-bit check


def _old_sub_chain(I, Uh, Ul, Mh, Ml):
    """pair_sub(pair_from_f64(I), pair_poly_plane(...)) as pexact ran it."""
    from sfft_tpu_torch.core.pairs import _two_sum

    plane = pairs.pair_poly_plain(Uh, Ul, Mh, Ml)
    hi = I.to(torch.float32)
    a = tef.CPair(hi, (I - hi.to(torch.float64)).to(torch.float32), None, None)
    h, e = _two_sum(a.rh, -plane.rh)
    return tef.CPair(h, a.rl - plane.rl + e, None, None)


def _old_add64_chain(Dfl, Uh, Ul, Mh, Ml):
    """fdiff_pexact's combination of the fluctuation pair and the main plane."""
    from sfft_tpu_torch.core.pairs import _two_sum

    main = pairs.pair_poly_plain(Uh, Ul, Mh, Ml)
    h, e = _two_sum(Dfl.rh, main.rh)
    return h.to(torch.float64) + (Dfl.rl + main.rl + e)


def _poly_coeffs(SP, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(SP, SP)) * 10.0 ** rng.uniform(-3, 3, size=(SP, SP))


def _poly_inputs(SP, N0, N1, seed, dev="cpu", edge=False, transposed=False):
    """K6p's tables as pexact makes them from seeded coefficients, an f64
    image of the plane's scale and a pair Dfl; with edge=True, tables, image
    and Dfl over 2^-60 .. 2^60 with +-0 and subnormal lo parts; transposed
    lays image and Dfl out with strides (1, N0)."""
    from sfft_tpu_torch.core import pexact as tpexact

    tabs = list(tpexact._poly_tables(torch.as_tensor(_poly_coeffs(SP, seed), device=dev), N0, N1))
    rng = np.random.default_rng(seed + 1)
    if edge:
        tabs = _edge((SP, N0), seed + 2, dev) + _edge((SP, N1), seed + 3, dev)
        dh, dl = _edge((N0, N1), seed + 4, dev)
        ih, il = _edge((N0, N1), seed + 5, dev)
        I = ih.double() + il
    else:
        scale = float(tabs[2].abs().max())
        I = torch.as_tensor(rng.normal(size=(N0, N1)) * scale * 10.0 ** rng.uniform(-2, 1, (N0, N1)),
                            device=dev)
        dh, dl = (torch.as_tensor(v, device=dev) for v in _split(
            rng.normal(size=(N0, N1)) * scale * 10.0 ** rng.uniform(-2, 1, (N0, N1))))
    if transposed:
        I, dh, dl = (v.t().contiguous().t() for v in (I, dh, dl))
    return tabs, I, pairs.CPair(dh, dl, None, None)


@pytest.mark.parametrize("case", ["SP 6", "SP 4 transposed", "SP 1", "edge values"])
def test_pair_poly_fused_twins_equal_the_old_chains(case):
    """The twins of K6p's sub and add64 modes give the bits of the chains
    they replace (torch against torch, bit for bit)."""
    SP, N0, N1 = {"SP 6": (6, 37, 50), "SP 4 transposed": (4, 41, 29), "SP 1": (1, 9, 7),
                  "edge values": (5, 33, 47)}[case]
    tabs, I, Dfl = _poly_inputs(SP, N0, N1, 40, edge=case == "edge values",
                                transposed="transposed" in case)
    assert _equal(pairs.pair_poly_sub_plain(I, *tabs), _old_sub_chain(I, *tabs))
    assert torch.equal(pairs.pair_poly_add64_plain(Dfl, *tabs), _old_add64_chain(Dfl, *tabs))
    # the CPU wrappers take the twins and launch nothing
    before = (pairs.pair_poly.launches, dict(pairs.pair_poly.mode_launches))
    assert _equal(pairs.pair_poly_sub(I, *tabs), _old_sub_chain(I, *tabs))
    assert torch.equal(pairs.pair_poly_add64(Dfl, *tabs), _old_add64_chain(Dfl, *tabs))
    assert (pairs.pair_poly.launches, pairs.pair_poly.mode_launches) == before


@pytest.mark.parametrize("SP, N0, N1", [(6, 48, 40), (4, 128, 96)])
def test_pair_poly_fused_modes_match_reference(SP, N0, N1):
    """K6p's sub mode against sfft_tpu's pair_sub(pair_from_f64(I),
    pair_poly_plane(C)) and its add64 mode against fdiff_pexact's f64
    materialisation (sfft_tpu/core/pexact.py:488-489) on the same pair,
    within 1e-13 of their maximum."""
    import jax
    import jax.numpy as jnp
    from sfft_tpu.core import pexact as jpexact

    from sfft_tpu_torch.core import pexact as tpexact

    jef = _jef()
    C = _poly_coeffs(SP, 41)
    tabs, I, Dfl = _poly_inputs(SP, N0, N1, 41)
    Inp = I.numpy()

    def ref_sub(c, x):
        return jpexact.pair_sub(jef.pair_from_f64(x), jpexact.pair_poly_plane(c, N0, N1))

    def ref_add64(c, dh, dl):
        main = jpexact.pair_poly_plane(c, N0, N1)
        h, e = jef._two_sum(dh, main.rh)
        return h.astype(jnp.float64) + (dl + main.rl + e)

    ref = jax.jit(ref_sub)(jnp.asarray(C), jnp.asarray(Inp))
    got = pairs.pair_poly_sub(I, *tpexact._poly_tables(torch.as_tensor(C), N0, N1))
    _close(_c128(got), np.asarray(ref.rh, np.float64) + np.asarray(ref.rl))
    ref = jax.jit(ref_add64)(jnp.asarray(C), Dfl.rh.numpy(), Dfl.rl.numpy())
    got = pairs.pair_poly_add64(Dfl, *tpexact._poly_tables(torch.as_tensor(C), N0, N1))
    _close(got.numpy(), np.asarray(ref))


def test_pair_poly_refusals():
    tabs, I, Dfl = _poly_inputs(3, 12, 10, 42)
    before = (pairs.pair_poly.launches, dict(pairs.pair_poly.mode_launches))
    with pytest.raises(ValueError, match="float64 image"):
        pairs.pair_poly_sub(I.float(), *tabs)
    with pytest.raises(ValueError, match="shape"):
        pairs.pair_poly_sub(I[:, :9], *tabs)
    with pytest.raises(ValueError, match="float32 planes"):
        pairs.pair_poly_add64(pairs.CPair(Dfl.rh.double(), Dfl.rl.double(), None, None), *tabs)
    with pytest.raises(ValueError, match="real pair"):
        pairs.pair_poly_add64(pairs.CPair(Dfl.rh, Dfl.rl, Dfl.rh, Dfl.rl), *tabs)
    with pytest.raises(ValueError, match="shape"):
        pairs.pair_poly_add64(pairs.CPair(Dfl.rh[1:], Dfl.rl[1:], None, None), *tabs)
    with pytest.raises(ValueError, match="float32 tables"):
        pairs.pair_poly_sub(I, *(t.double() for t in tabs))
    with pytest.raises(ValueError, match="at most 32 terms"):
        pairs.pair_poly(*(torch.ones(33, 4) for _ in range(4)))
    # a device that is neither the CPU nor CUDA
    meta = [t.to("meta") for t in tabs]
    with pytest.raises(ValueError, match="cpu or cuda"):
        pairs.pair_poly_sub(I.to("meta"), *meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pairs.pair_poly_add64(pairs.CPair(Dfl.rh.to("meta"), Dfl.rl.to("meta"), None, None),
                              *meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pairs.pair_poly(*meta)
    # the kernel takes row-major or transposed planes of one layout and
    # copies nothing: any other layout raises
    assert pairs._transposed("k", [I], I.shape) is False
    assert pairs._transposed("k", [I.t().contiguous().t()], I.shape) is True
    with pytest.raises(ValueError, match="row-major or transposed"):
        pairs._transposed("k", [Dfl.rh, Dfl.rl.t().contiguous().t()], I.shape)
    wide = torch.zeros(12, 20, dtype=torch.float64)
    with pytest.raises(ValueError, match="row-major or transposed"):
        pairs._transposed("k", [wide[:, ::2]], I.shape)
    assert (pairs.pair_poly.launches, pairs.pair_poly.mode_launches) == before


def _f32(x):
    return np.float32(x)


def test_rr_and_scale_pair_orders_bit_for_bit():
    """rr's lo = (e + h wl) + l wh and scale_pair's lo = (e + l c) + h cres
    are two orders of the same three terms; each twin keeps its own, bit for
    bit with a numpy f32 emulation, on inputs where the two orders part."""
    rng = np.random.default_rng(12)
    h, l = _split(rng.normal(size=4000) * 10.0 ** rng.uniform(-3, 3, size=4000))
    wh, wl = _split(rng.normal(size=4000))
    e = pairs._two_prod(torch.as_tensor(h), torch.as_tensor(wh))[1].numpy()
    rr = _f32(_f32(e + _f32(h * wl)) + _f32(l * wh))
    sc = _f32(_f32(e + _f32(l * wh)) + _f32(h * wl))
    assert np.any(rr != sc)                             # the orders part on these inputs
    _, lo = pairs._rr(torch.as_tensor(h), torch.as_tensor(l), torch.as_tensor(wh),
                      torch.as_tensor(wl))
    np.testing.assert_array_equal(lo.numpy(), rr)
    # scale_pair by a scalar (c32, cres) per element: the other order
    for k in range(0, 4000, 997):
        got = pairs._scale_pair(_t([h, l, h, l]), torch.tensor(wh[k]), torch.tensor(wl[k]))
        pk, ek = (v.numpy() for v in pairs._two_prod(torch.as_tensor(h), torch.tensor(wh[k])))
        want = _f32(_f32(ek + _f32(l * wh[k])) + _f32(h * wl[k]))
        np.testing.assert_array_equal(got.rl.numpy(), want)
        np.testing.assert_array_equal(got.rh.numpy(), pk)


# --- the model spectrum's inline loops as fdiff_exact and fdiff_pexact ran
# them before K6m (core/fdiff.py, core/pexact.py), for the bit-for-bit check


def _old_model_loop(sp, K, a00, s_nc, nss, separate_varying, SCALE, foldj, pexact):
    from sfft_tpu_torch.core.exact_fft import CPair, _pair_hadamard_conj, _pmap, _split_on
    from sfft_tpu_torch.core.pairs import _two_prod, _two_sum

    dev = sp.rh.device

    def split64(c):
        c32 = c.to(torch.float32)
        return c32, (c - c32.to(torch.float64)).to(torch.float32)

    def shift_pair(P, c):
        c32, cres = split64(c)
        h, e = _two_sum(P.rh, c32.expand(P.rh.shape))
        return CPair(h, P.rl + e + cres, P.ih, P.il)

    def scale_pair(P, c32, cres):
        pr, er = _two_prod(P.rh, c32.expand(P.rh.shape))
        pi, ei = _two_prod(P.ih, c32.expand(P.ih.shape))
        return CPair(pr, er + P.rl * c32 + P.rh * cres,
                     pi, ei + P.il * c32 + P.ih * cres)

    def addp(acc, term):
        if acc is None:
            return term
        hr, er = _two_sum(acc.rh, term.rh)
        hi, ei = _two_sum(acc.ih, term.ih)
        return CPair(hr, acc.rl + term.rl + er, hi, acc.il + term.il + ei)

    def plane(P, k):
        return _pmap(P, lambda v: v[k])

    Fk = K.rh.shape[0]
    acc = None
    for i in range(Fk):
        if pexact:
            c_i = (a00[i] - s_nc[i]) if not separate_varying else -s_nc[i]
        else:
            c_i = -s_nc[i] if separate_varying else a00[i] - s_nc[i]
        Ki = shift_pair(plane(K, i), c_i)
        acc = addp(acc, _pair_hadamard_conj(plane(sp, 1 + i),
                                            CPair(Ki.rh, Ki.rl, -Ki.ih, -Ki.il)))
    if separate_varying:
        for i in range(nss):
            acc = addp(acc, scale_pair(plane(sp, 1 + Fk + i), *split64(a00[i])))
    m = scale_pair(acc, *_split_on(Static(np.float64, (float(SCALE),)), dev))
    dr, er = _two_sum(sp.rh[0], -m.rh)
    di, ei = _two_sum(sp.ih[0], -m.ih)
    FD = CPair(dr, sp.rl[0] - m.rl + er, di, sp.il[0] - m.il + ei)
    return _pmap(FD, lambda v: v * foldj)


@pytest.mark.parametrize("case", ["entangled", "separate-varying"])
def test_model_spectrum_twin_bit_identical_to_old_loops(case):
    from sfft_tpu_torch.core.fdiff import _fold_weights, pair_model_spectrum
    from sfft_tpu_torch.core.statics import table

    Fk, nss, sv = (6, 0, False) if case == "entangled" else (25, 6, True)
    N0, N1 = 24, 18
    N1h = N1 // 2 + 1
    rng = np.random.default_rng(13)
    sp = _t(_cpair((1 + Fk + nss, N0, N1h), 14))
    K = _t(_cpair((Fk, N0, N1h), 15))
    a_ijab = rng.normal(size=(Fk, 5, 5)) * 10.0 ** rng.uniform(-3, 1, size=(Fk, 1, 1))
    a_ijab = torch.as_tensor(a_ijab)
    a00 = a_ijab[:, 2, 2]
    s_nc = a_ijab.sum(dim=(1, 2)) - a00
    SCALE = 1.0 / 3.7
    foldj = table(Static(_fold_weights, (N1,)), "cpu")
    # the fields of the config the model reads
    cfg = types.SimpleNamespace(scaling_mode="SEPARATE-VARYING" if sv else "ENTANGLED",
                                SCALE=SCALE, N1=N1)
    got = pair_model_spectrum(cfg, sp, K, a00, s_nc, nss)
    for pexact in (False, True):
        want = _old_model_loop(sp, K, a00, s_nc, nss, sv, SCALE, foldj, pexact)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _gather(ptr, strides, sizes, nd, n, owner):
    """The values a kernel thread reads for each output element: the plan's
    index decomposition over the storage that holds `ptr` (numpy)."""
    st = owner.untyped_storage()
    flat = torch.empty(0, dtype=torch.float32).set_(st, 0, (st.nbytes() // 4,), (1,))
    off = np.full(n, (ptr - st.data_ptr()) // 4, dtype=np.int64)
    r = np.arange(n, dtype=np.int64)
    for d in range(nd):
        i = r if d == nd - 1 else r % sizes[d]
        if d < nd - 1:
            r = r // sizes[d]
        off += i * strides[d]
    return flat[torch.as_tensor(off)]


def _in_layout(flat, like):
    """The values `flat` (in memory order) as a tensor with like's shape and
    strides."""
    return torch.empty_like(like).as_strided(like.shape, like.stride()).copy_(
        flat.as_strided(like.shape, like.stride()))


def _views():
    """Operands with offsets, strides, transposes and broadcast tables."""
    rng = np.random.default_rng(16)
    base = torch.as_tensor(rng.normal(size=(4, 3, 40, 70)).astype(np.float32))
    tbase = torch.as_tensor(rng.normal(size=(4, 60, 50)).astype(np.float32))
    a = [base[k, :, :, 5:65:2] for k in range(4)]                       # (3, 40, 30)
    b = [tbase[k, 10:40, 5:45].t() for k in range(4)]                   # (40, 30)
    # a dense transposed plane (an image in FITS order): the outputs follow its layout
    img = torch.as_tensor(rng.normal(size=(2, 30, 40)).astype(np.float32))
    tw = [torch.as_tensor(rng.normal(size=(8, 6)).astype(np.float32)) for _ in range(4)]
    g = [torch.as_tensor(rng.normal(size=(5, 8, 6)).astype(np.float32)) for _ in range(4)]
    col = [torch.as_tensor(rng.normal(size=(40, 1)).astype(np.float32)) for _ in range(2)]
    row = [torch.as_tensor(rng.normal(size=(1, 30)).astype(np.float32)) for _ in range(2)]
    sc = [torch.tensor(np.float32(v)) for v in rng.normal(size=2)]
    R = lambda p: pairs.CPair(p[0], p[1], None, None)                   # noqa: E731
    return [
        ("hadamard_conj", pairs.CPair(*a), pairs.CPair(*b), None),
        ("mul_static", pairs.CPair(*g), pairs.CPair(*tw), None),
        ("mul_static", pairs.CPair(*a), pairs.CPair(*b), None),
        ("mul_static_rr", R(a), R(col), None),
        ("mul_static_rr", pairs.CPair(*a), R(col), None),
        ("mul_static_rr", R(b), R(sc), None),
        ("sep_mul", R(b), R(col), R(row)),
        ("sep_mul", R([v.t() for v in img]), R(col), R(row)),
        # a table whose planes differ in strides only along an extent-1 axis
        ("mul_static_rr", R(b), R([row[0], row[1].reshape(30).as_strided((1, 30), (1, 1))]),
         None),
        ("hadamard_conj", pairs.CPair(*(v.contiguous() for v in a)),
         pairs.CPair(*(v.contiguous() for v in a)), None),
    ]


def test_launch_plan_gathers_the_operands():
    """K6a's launch arguments (pairs._pp_args) read, element by element,
    what the twin reads: the operands gathered by the plan's decomposition
    give the twin's bits, with no operand copied; contiguous operands
    collapse to one axis."""
    copies = pairs.pair_products.copies
    for mode, A, B, C in _views():
        shape = pairs._pp_check(mode, A, B, C)
        n = int(np.prod(shape))
        outs = pairs._pp_outs(A, shape, 2 if A.is_real else 4)
        args, views = pairs._pp_args(mode, A, B, C, shape, outs)
        assert args.mode == pairs._KMODE[(mode, A.is_real)] and args.n == n
        sizes = list(args.size)[:args.nd]
        assert int(np.prod(sizes)) == n
        ops = []
        for field, sfield, vs, p in zip(("a", "b", "c"), ("sa", "sb", "sc"), views,
                                        [A, B, C]):
            if p is None:
                continue
            # element e of the plan is element e of the outputs' memory
            planes = [_in_layout(_gather(getattr(args, field)[k], list(getattr(args, sfield)),
                                         sizes, args.nd, n, v), outs[0])
                      for k, v in enumerate(vs)]
            ops.append(pairs.CPair(*planes, *([None] * (4 - len(planes)))))
        want = pairs.pair_products_plain(mode, A, B, C)
        got = pairs.pair_products_plain(mode, *ops)
        for g, w in zip(got, want):
            assert (g is None) == (w is None) and (g is None or torch.equal(g, w))
    assert pairs.pair_products.copies == copies
    contiguous = _views()[-1]
    shape = pairs._pp_check(*contiguous)
    assert pairs._pp_args(*contiguous, shape, [torch.empty(shape)] * 4)[0].nd == 1
    transposed = _views()[-3]
    shape = pairs._pp_check(*transposed)
    outs = pairs._pp_outs(transposed[1], shape, 2)
    assert outs[0].stride() == transposed[1].rh.stride() == (1, 40)
    args = pairs._pp_args(*transposed, shape, outs)[0]
    assert list(args.sa)[:2] == [1, 40]             # A read in memory order


def test_refusals():
    x = _t(_cpair((6, 5), 17, real=True))
    z = _t(_cpair((6, 5), 18))
    W = Static(_table, (19, (6, 1), "r"))
    with pytest.raises(ValueError, match="real pair"):
        tef._pair_mul_static_rr(z, W)                       # complex where real is required
    with pytest.raises(ValueError, match="real"):
        tef.pair_sep_mul(z, W, Static(_table, (20, (1, 5), "r")))
    with pytest.raises(ValueError, match="complex"):
        pairs.pair_products("hadamard_conj", x, z)
    with pytest.raises(ValueError, match="real pair"):
        pairs.pair_products("mul_static_rr", x, z)          # a complex factor
    with pytest.raises(ValueError, match="broadcast"):
        pairs.pair_products("hadamard_conj", z, _t(_cpair((7, 5), 21)))
    with pytest.raises(ValueError, match="broadcast"):
        pairs.pair_products("mul_static_rr", x, pairs.CPair(torch.ones(5, 1), torch.ones(5, 1),
                                                            None, None))
    with pytest.raises(ValueError, match="unknown mode"):
        pairs.pair_products("hadamard", z, z)
    with pytest.raises(ValueError, match="float32"):
        pairs.pair_products("hadamard_conj", z, pairs.CPair(*(v.double() for v in z)))
    with pytest.raises(ValueError, match="differ in shape"):
        pairs.pair_products("hadamard_conj", z, pairs.CPair(z.rh, z.rl[:1], z.ih, z.il))
    launched = (pairs.pair_products.launches, pairs.pair_model.launches)
    sp = _t(_cpair((3, 6, 4), 22))
    K = _t(_cpair((2, 6, 4), 23))
    sc = (torch.tensor(np.float32(0.5)), torch.tensor(np.float32(0.0)))
    c = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="inconsistent"):
        pairs.pair_model(sp, K, c, torch.zeros(1, dtype=torch.float64), sc, None)  # 1+2+1 > 3
    with pytest.raises(ValueError, match="complex"):
        pairs.pair_model(sp, pairs.CPair(K.rh, K.rl, None, None), c, None, sc, None)
    with pytest.raises(ValueError, match="float64"):
        pairs.pair_model(sp, K, c.float(), None, sc, None)
    with pytest.raises(ValueError, match="SP, N0"):
        pairs.pair_poly(torch.ones(3, 4), torch.ones(3, 4), torch.ones(2, 5), torch.ones(2, 5))
    # the CPU wrappers launch nothing
    pairs.pair_model(sp, K, c, None, sc, torch.ones(4))
    assert (pairs.pair_products.launches, pairs.pair_model.launches) == launched


def _dispatch_cases():
    from sfft_tpu_torch.config import BasisSpec, SFFTConfig

    rng = np.random.default_rng(24)
    yy, xx = np.meshgrid(np.arange(32), np.arange(40))
    I = 100.0 + 0.3 * xx + 0.5 * yy
    for _ in range(8):
        x0, y0 = rng.uniform(3, 37), rng.uniform(3, 29)
        I = I + rng.uniform(50, 400) * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 2.0)
    J = 1.1 * I + 4.0 + rng.normal(0, 1.0, I.shape)
    I = I + rng.normal(0, 0.7, I.shape)
    pexact = SFFTConfig(N0=40, N1=32, w0=2, w1=2, kernel_basis=BasisSpec("polynomial", 1),
                        bg_basis=BasisSpec("polynomial", 1), greek_backend="pexact",
                        fdiff_backend="pexact", solver="transformed")
    v2 = SFFTConfig(N0=40, N1=32, w0=1, w1=1,
                    kernel_basis=BasisSpec("bspline", 1, (20.0,), ()),
                    bg_basis=BasisSpec("polynomial", 0),
                    scaling_basis=BasisSpec("polynomial", 1), greek_backend="exact",
                    fdiff_backend="exact", solver="exact")
    return I, J, {"pexact": pexact, "v2 exact": v2}


def test_paths_run_every_pair_product_through_the_wrappers(monkeypatch):
    """A CUDA-less stub in place of each kernel wrapper: with plain=False
    every pair product of the pexact and the v2 exact path goes through the
    wrappers (the twins refuse calls from anywhere else), every K6a mode
    among them, the polynomial planes through K6p's fused modes (two sub
    launches and one add64 a step, no plane); with plain=True none does,
    and the bits are the same."""
    from sfft_tpu_torch.core import engine

    I, J, cfgs = _dispatch_cases()
    wrappers = {"pair_products": "pair_products_plain", "pair_model": "pair_model_spectrum_plain",
                "pair_poly": "pair_poly_plain", "pair_poly_sub": "pair_poly_sub_plain",
                "pair_poly_add64": "pair_poly_add64_plain"}
    twins = {k: getattr(pairs, t) for k, t in wrappers.items()}
    inside = [0]
    calls = {}

    def stub(name):
        def run(*args):
            calls[name] = calls.get(name, 0) + 1
            if name == "pair_products":
                calls[("mode", args[0], args[1].is_real)] = 1
            inside[0] += 1
            try:
                return twins[name](*args)
            finally:
                inside[0] -= 1
        return run

    def guarded(name, twin):
        def run(*args):
            assert inside[0], f"{name} ran outside its kernel wrapper"
            return twin(*args)
        return run

    for name, twin_name in wrappers.items():
        monkeypatch.setattr(pairs, name, stub(name))
        monkeypatch.setattr(pairs, twin_name, guarded(twin_name, twins[name]))
    got = {k: engine.GeneralSFFT.GSS(I, J, I, J, cfg, device="cpu")[:2]
           for k, cfg in cfgs.items()}
    assert all(calls.get(k, 0) > 0 for k in wrappers if k != "pair_poly"), calls
    # one step each (masked == unmasked): the pexact step's planes
    assert (calls.get("pair_poly", 0), calls["pair_poly_sub"], calls["pair_poly_add64"]) == \
        (0, 2, 1), calls
    assert {k[1:] for k in calls if isinstance(k, tuple)} == {
        ("hadamard_conj", False), ("mul_static", False), ("mul_static_rr", True),
        ("mul_static_rr", False), ("sep_mul", True)}, calls
    # plain=True: the twins, no wrapper
    for name, twin_name in wrappers.items():
        monkeypatch.setattr(pairs, twin_name, twins[name])

        def refuse(*args, _name=name):
            raise AssertionError(f"{_name} ran with plain=True")

        monkeypatch.setattr(pairs, name, refuse)
    for k, cfg in cfgs.items():
        sol, diff = engine.GeneralSFFT.GSS(I, J, I, J, cfg, device="cpu", plain=True)[:2]
        assert torch.equal(sol, got[k][0]) and torch.equal(diff, got[k][1]), k


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _edge(shape, seed, dev, ex=60):
    """A pair plane over magnitudes near 2^-ex .. 2^ex, with +-0 and
    subnormal lo parts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 2.0 ** rng.integers(-ex, ex + 1, size=shape)
    hi, lo = _split(x)
    flat_h, flat_l = hi.reshape(-1), lo.reshape(-1)
    k = flat_h.size
    flat_h[: k // 16] = 0.0
    flat_l[: k // 16] = 0.0
    flat_h[k // 16: k // 8] = -0.0
    flat_l[k // 16: k // 8] = -0.0
    flat_l[k // 8: k // 4] = rng.normal(size=k // 4 - k // 8) * 2.0 ** -135   # subnormal
    perm = rng.permutation(k)
    return [torch.as_tensor(flat_h[perm].reshape(shape), device=dev),
            torch.as_tensor(flat_l[perm].reshape(shape), device=dev)]


def _equal(got, want):
    return all((g is None) == (w is None) and (g is None or torch.equal(g, w))
               for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(10))
def test_pair_products_kernel_bit_identical_to_twin_on_gpu(cuda, case):
    mode, A, B, C = _views()[case]
    move = lambda p: None if p is None else pairs.CPair(   # noqa: E731
        *(None if v is None else v.to(cuda) for v in p))
    A, B, C = move(A), move(B), move(C)
    before = pairs.pair_products.launches
    got = pairs.pair_products(mode, A, B, C)
    torch.cuda.synchronize()
    assert pairs.pair_products.launches == before + 1
    assert _equal(got, pairs.pair_products_plain(mode, A, B, C)), mode


@pytest.mark.gpu
@pytest.mark.parametrize("mode", pairs.MODES)
def test_pair_products_kernel_edge_values_on_gpu(cuda, mode):
    """+-0, subnormal lo parts and magnitudes near 2^+-60, on views at an
    offset, with broadcast tables."""
    shape = (3, 33, 47)
    A = pairs.CPair(*_edge(shape, 25, cuda), *_edge(shape, 26, cuda))
    base = [torch.zeros((2,) + shape, device=cuda) for _ in range(4)]
    B = pairs.CPair(*(b[1] for b in base))
    for b, v in zip(base, _edge(shape, 27, cuda) + _edge(shape, 28, cuda)):
        b[1].copy_(v)
    # real tables over 2^-30 .. 2^30: a product of three factors stays finite
    col = pairs.CPair(*_edge((33, 1), 29, cuda, ex=30), None, None)
    row = pairs.CPair(*_edge((1, 47), 30, cuda, ex=30), None, None)
    real = pairs.CPair(A.rh, A.rl, None, None)
    args = {"hadamard_conj": (A, B, None),
            "mul_static": (A, pairs.CPair(*_edge((33, 47), 31, cuda), *_edge((33, 47), 32, cuda)),
                           None),
            "mul_static_rr": (A, col, None),
            "sep_mul": (real, col, row)}[mode]
    got = pairs.pair_products(mode, *args)
    torch.cuda.synchronize()
    assert _equal(got, pairs.pair_products_plain(mode, *args)), mode
    if mode == "mul_static_rr":
        got = pairs.pair_products(mode, real, row)
        assert _equal(got, pairs.pair_products_plain(mode, real, row))


@pytest.mark.gpu
@pytest.mark.parametrize("nss", [0, 6])
def test_pair_model_kernel_bit_identical_to_twin_on_gpu(cuda, nss):
    from sfft_tpu_torch.core.fdiff import _fold_weights
    from sfft_tpu_torch.core.statics import table

    Fk, N0, N1 = (6, 40, 34) if nss == 0 else (25, 30, 29)
    N1h = N1 // 2 + 1
    # sp as a view at an offset (a stack with a plane in front)
    big = _t(_cpair((2 + Fk + nss, N0, N1h), 33), cuda)
    sp = pairs.CPair(*(v[1:] for v in big))
    K = pairs.CPair(*_edge((Fk, N0, N1h), 34, cuda), *_edge((Fk, N0, N1h), 35, cuda))
    rng = np.random.default_rng(36)
    c = torch.as_tensor(rng.normal(size=Fk) * 10.0 ** rng.uniform(-3, 3, size=Fk), device=cuda)
    a00 = torch.as_tensor(rng.normal(size=nss), device=cuda) if nss else None
    scale = tef._split_on(Static(np.float64, (1.0 / 3.7,)), cuda)
    for fold in (None, table(Static(_fold_weights, (N1,)), cuda)):
        before = pairs.pair_model.launches
        got = pairs.pair_model(sp, K, c, a00, scale, fold)
        torch.cuda.synchronize()
        assert pairs.pair_model.launches == before + 1
        assert _equal(got, pairs.pair_model_spectrum_plain(sp, K, c, a00, scale, fold))


@pytest.mark.gpu
def test_pair_poly_kernel_bit_identical_to_twin_on_gpu(cuda):
    from sfft_tpu_torch.core import pexact as tpexact

    rng = np.random.default_rng(37)
    for SP, N0, N1 in [(6, 130, 97), (9, 64, 256), (1, 5, 3)]:
        C = torch.as_tensor(rng.normal(size=(SP, SP)) * 10.0 ** rng.uniform(-3, 3, (SP, SP)),
                            device=cuda)
        before = pairs.pair_poly.launches
        got = tpexact.pair_poly_plane(C, N0, N1)
        torch.cuda.synchronize()
        assert pairs.pair_poly.launches == before + 1
        assert _equal(got, tpexact.pair_poly_plane(C, N0, N1, plain=True))
    Uh, Ul = _edge((4, 50), 38, cuda)
    Mh, Ml = _edge((4, 70), 39, cuda)
    assert _equal(pairs.pair_poly(Uh, Ul, Mh, Ml), pairs.pair_poly_plain(Uh, Ul, Mh, Ml))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["plane", "sub", "add64"])
@pytest.mark.parametrize("SP", [1, 4, 6])
def test_pair_poly_modes_kernel_bit_identical_to_twin_on_gpu(cuda, mode, SP):
    """Each K6p mode against its twin, bit for bit, one launch a call: a
    width that is not a multiple of the 128-column tile (and rows not of
    the 32-row tile), an odd width (the scalar epilogue), transposed inputs,
    edge values, and 4096^2."""
    shapes = [(70, 300, False, False), (45, 97, False, False), (33, 47, False, True),
              (4096, 4096, False, False)]
    if mode != "plane":
        shapes += [(300, 70, True, False), (97, 45, True, False), (47, 33, True, True)]
    for N0, N1, transposed, edge in shapes:
        tabs, I, Dfl = _poly_inputs(SP, N0, N1, 43 + SP, cuda, edge=edge, transposed=transposed)
        before = pairs.pair_poly.launches
        if mode == "plane":
            got, want = pairs.pair_poly(*tabs), pairs.pair_poly_plain(*tabs)
        elif mode == "sub":
            got, want = pairs.pair_poly_sub(I, *tabs), pairs.pair_poly_sub_plain(I, *tabs)
            assert got.rh.stride() == I.to(torch.float32).stride()
        else:
            got = pairs.pair_poly_add64(Dfl, *tabs)
            want = pairs.pair_poly_add64_plain(Dfl, *tabs)
            assert got.stride() == Dfl.rh.stride()
        torch.cuda.synchronize()
        assert pairs.pair_poly.launches == before + 1
        same = _equal(got, want) if mode != "add64" else torch.equal(got, want)
        assert same, (mode, SP, N0, N1, transposed, edge)
