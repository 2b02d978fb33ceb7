"""sfft_tpu_torch's host preprocessing pieces against sfft_tpu: the native
extension (Hough accumulator, connected-component labeller, RICE_1
decoder) against sfft_tpu.native's and against the port's own numpy twins,
RICE_1 round trips through an encoder written here with CFITSIO's
fits_rcomp semantics, and tile-compressed FITS read through the port's
io/fits.py.

Inputs are made from seeds with numpy. sfft_tpu is imported inside the
tests that use it, so that the `gpu` cases (ESP on the card against ESP on
the plain twins on the card, at the golden pair's size) run on a machine
without JAX (``python -m pytest --noconftest -m gpu``).
"""

import os

import numpy as np
import pytest
import torch

from sfft_tpu_torch import native
from sfft_tpu_torch.io import fits

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def reference_native():
    import sfft_tpu  # noqa: F401
    from sfft_tpu import native as jnative

    assert jnative._try_load() is not None, "sfft_tpu's native extension did not load"
    return jnative


# --- RICE_1 encoder (CFITSIO fits_rcomp, 32-bit pixels) ---------------------

def rice_encode(a: np.ndarray, blocksize: int = 32) -> bytes:
    """CFITSIO fits_rcomp for int32 pixels: the first pixel as 4 big-endian
    bytes, then per block a 5-bit split code and the Rice-coded mapped
    differences (all-zero blocks: code 0; high entropy: code 26 and raw
    32-bit differences). Differences wrap in int32, as in C."""
    a = np.asarray(a, np.int32)
    bits = []

    def put(value: int, n: int):
        bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    put(int(a[0]), 32)
    fsbits, fsmax = 5, 25
    last = int(a[0])
    for i in range(0, len(a), blocksize):
        block = a[i:i + blocksize]
        diff = []
        for nxt in block:
            nxt = int(nxt)
            pdiff = ((nxt - last + 2**31) % 2**32) - 2**31
            diff.append((~(pdiff << 1) if pdiff < 0 else (pdiff << 1)) & 0xFFFFFFFF)
            last = nxt
        n = len(block)
        pixelsum = float(sum(diff))
        dpsum = max((pixelsum - (n // 2) - 1) / n, 0.0)
        psum = int(dpsum) >> 1
        fs = psum.bit_length()
        if fs >= fsmax:
            put(fsmax + 1, fsbits)
            for v in diff:
                put(v, 32)
        elif fs == 0 and pixelsum == 0:
            put(0, fsbits)
        else:
            put(fs + 1, fsbits)
            for v in diff:
                bits.append("0" * (v >> fs) + "1")
                if fs:
                    put(v, fs)
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def rice_tiles(seed: int):
    """Seeded int32 tiles: constant, smooth with small noise, full 32-bit
    range, mixed blocks (constant, noisy, full range), one pixel, and a
    length that is no multiple of the block size."""
    rng = np.random.default_rng(seed)
    full = lambda n: rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return {
        "constant": np.full(96, -123456, np.int32),
        "zeros": np.zeros(64, np.int32),
        "smooth": (1000 + np.cumsum(rng.integers(-3, 4, 200))).astype(np.int32),
        "noisy": rng.integers(-5000, 5000, 257).astype(np.int32),
        "full_range": full(160),
        "extremes": np.array([2**31 - 1, -2**31] * 40, np.int32),
        "mixed": np.concatenate([np.full(32, 7, np.int32),
                                 rng.integers(0, 40, 32).astype(np.int32),
                                 full(32), np.full(13, -2**31, np.int32)]),
        "one": np.array([42], np.int32),
    }


# sfft_tpu's decoder keeps the low 8 - nbits bits of the byte that ends a raw
# 32-bit value (high-entropy block) where CFITSIO keeps the low nbits: with
# nbits > 4 pending, the next value loses bits. Its C++ and Python decoders
# share the fault; the port decodes as CFITSIO does. These seeded streams
# reach it:
REFERENCE_DROPS_BITS = {("full_range", 32), ("full_range", 16), ("mixed", 16)}


@pytest.mark.parametrize("blocksize", [32, 16])
@pytest.mark.parametrize("kind", list(rice_tiles(0)))
def test_rice_round_trip_matches_reference_and_twin(kind, blocksize):
    tile = rice_tiles(11)[kind]
    stream = rice_encode(tile, blocksize)
    out = native.rice_decode(stream, tile.size, blocksize)
    assert native.available()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, tile)
    np.testing.assert_array_equal(native.rice_decode_numpy(stream, tile.size, blocksize), tile)
    ref = reference_native().rice_decode(stream, tile.size, blocksize)
    if (kind, blocksize) in REFERENCE_DROPS_BITS:
        assert not np.array_equal(ref, tile)
    else:
        np.testing.assert_array_equal(ref, tile)


def test_rice_decoders_refuse_exhausted_streams():
    stream = rice_encode(np.arange(64, dtype=np.int32) * 3)
    with pytest.raises(ValueError, match="exhausted"):
        native.rice_decode(stream[:8], 64)
    with pytest.raises(ValueError, match="exhausted"):
        native.rice_decode_numpy(stream[:8], 64)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_hough_accum_matches_reference_and_twin(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    x = rng.integers(0, 120, n)
    y = rng.integers(0, 90, n)
    theta = np.linspace(-np.pi / 2, np.pi / 2, 181, endpoint=False)
    # lines through integer points land on exact .5 ties: half away from zero
    ct, st = np.cos(theta), np.sin(theta)
    dmax = 2 * int(np.ceil(np.hypot(120, 90)))
    out = native.hough_accum(x, y, ct, st, dmax)
    assert native.available()
    assert out.dtype == np.uint64 and out.shape == (dmax, theta.size)
    assert int(out.sum()) == n * theta.size
    np.testing.assert_array_equal(out, native.hough_accum_numpy(x, y, ct, st, dmax))
    np.testing.assert_array_equal(out, reference_native().hough_accum(x, y, ct, st, dmax))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("seed,density", [(4, 0.3), (5, 0.55), (6, 0.8)])
def test_label_matches_reference_and_twin(seed, density, connectivity):
    rng = np.random.default_rng(seed)
    mask = rng.random((67, 91)) < density
    mask[:, 0] = True  # a component that touches the edge
    lab, n = native.label(mask, connectivity)
    assert native.available()
    assert lab.dtype == np.int32 and n == int(lab.max())
    tlab, tn = native.label_numpy(mask, connectivity)
    np.testing.assert_array_equal(lab, tlab)
    assert n == tn
    jlab, jn = reference_native().label(mask, connectivity)
    np.testing.assert_array_equal(lab, jlab)
    assert n == jn


# --- the numpy modules off the packets' main path --------------------------

def test_canny_and_hough_detection_match_reference():
    """utils/canny.py and HoughDetection's canny branch (the packets' Hough
    classifier takes the count-threshold branch) on a seeded image."""
    import sfft_tpu  # noqa: F401
    from sfft_tpu.utils.canny import canny as jcanny
    from sfft_tpu.utils.hough import HoughDetection as JHD

    from sfft_tpu_torch.utils.canny import canny
    from sfft_tpu_torch.utils.hough import HoughDetection

    rng = np.random.default_rng(12)
    img = rng.normal(0, 0.3, (80, 70))
    img[:, 35:] += 10.0
    img[20:23, :] += 6.0
    np.testing.assert_array_equal(canny(img, sigma=1.5), jcanny(img, sigma=1.5))
    got = HoughDetection.HD(PixA_obj=img, canny_sig=1.5)
    ref = JHD.HD(PixA_obj=img, canny_sig=1.5)
    assert len(got[2]) > 0
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)


def test_sky_subtract_matches_reference(tmp_path):
    """prep/sky_subtract.py on a seeded field with a sloped sky: the same
    sky, sky RMS and sky-subtracted FITS as sfft_tpu's."""
    import sfft_tpu  # noqa: F401
    from sfft_tpu.prep.sky_subtract import SExSkySubtract as JSSS

    from sfft_tpu_torch.prep.sky_subtract import SExSkySubtract

    rng = np.random.default_rng(17)
    n = 160
    yy, xx = np.meshgrid(np.arange(n), np.arange(n))
    img = 200.0 + 0.3 * xx + 0.1 * yy + rng.normal(0, 2.0, (n, n))
    for x0, y0, f in zip(rng.uniform(10, n - 10, 40), rng.uniform(10, n - 10, 40),
                         10 ** rng.uniform(3, 4.5, 40)):
        img += f / (2 * np.pi * 1.6) * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 3.2)
    hdr = fits.Header()
    hdr.add("SATURATE", 60000.0)
    fits.write(str(tmp_path / "in.fits"), img.T, hdr)
    outs = []
    for sss, tag in ((SExSkySubtract, "t"), (JSSS, "j")):
        res = sss.SSS(FITS_obj=str(tmp_path / "in.fits"),
                      FITS_skysub=str(tmp_path / f"skysub_{tag}.fits"), VERBOSE_LEVEL=0)
        outs.append((res, fits.read(str(tmp_path / f"skysub_{tag}.fits"))))
    (got, (gimg, ghdr)), (ref, (rimg, rhdr)) = outs
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(gimg, rimg)
    assert ghdr["ESATUR"] == rhdr["ESATUR"] < 60000.0


# --- tile-compressed FITS ---------------------------------------------------

def _card(key, value):
    return fits._format_card(key, value)


def write_tiled(path, image, tile, quantize=None, dither0=1):
    """Write `image` (numpy (NAXIS2, NAXIS1)) as a RICE_1 tile-compressed
    image extension after an empty primary HDU. Integer images are stored
    as they are; float images are quantized by `quantize` =
    (zscale, zzero, "NO_DITHER" | "SUBTRACTIVE_DITHER_1") with CFITSIO's
    rule (ints = nint((v - zzero) / zscale + r - 0.5), r the tile's dither
    sequence, 0.5 without dither)."""
    ny, nx = image.shape
    tx, ty = tile
    rows, scales, zeros = [], [], []
    rand = fits._fits_rand_values()
    n = 0
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            block = image[y0:y0 + ty, x0:x0 + tx].ravel()
            if quantize is None:
                ints = block.astype(np.int32)
            else:
                zscale, zzero, method = quantize
                if method == "SUBTRACTIVE_DITHER_1":
                    iseed = (n + dither0 - 1) % 10000
                    r = rand[int(rand[iseed] * 500.0) + np.arange(block.size)]
                else:
                    r = 0.5
                ints = np.rint((block - zzero) / zscale + r - 0.5).astype(np.int32)
                scales.append(zscale)
                zeros.append(zzero)
            rows.append(rice_encode(ints))
            n += 1
    heap = b"".join(rows)
    offs = np.cumsum([0] + [len(r) for r in rows[:-1]])
    float_cols = quantize is not None
    rowlen = 8 + (16 if float_cols else 0)
    table = bytearray()
    for k, r in enumerate(rows):
        table += np.array([len(r), offs[k]], ">i4").tobytes()
        if float_cols:
            table += np.array([scales[k], zeros[k]], ">f8").tobytes()
    cards = [_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
             _card("EXTEND", True), b"END".ljust(80)]
    prim = b"".join(cards)
    prim += b" " * (-len(prim) % 2880)
    ext = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8), _card("NAXIS", 2),
           _card("NAXIS1", rowlen), _card("NAXIS2", len(rows)), _card("PCOUNT", len(heap)),
           _card("GCOUNT", 1), _card("TFIELDS", 3 if float_cols else 1),
           _card("TTYPE1", "COMPRESSED_DATA"),
           _card("TFORM1", f"1PB({max(len(r) for r in rows)})")]
    if float_cols:
        ext += [_card("TTYPE2", "ZSCALE"), _card("TFORM2", "1D"),
                _card("TTYPE3", "ZZERO"), _card("TFORM3", "1D"),
                _card("ZQUANTIZ", quantize[2]), _card("ZDITHER0", dither0)]
    ext += [_card("ZIMAGE", True), _card("ZBITPIX", -32 if float_cols else 32),
            _card("ZNAXIS", 2), _card("ZNAXIS1", nx), _card("ZNAXIS2", ny),
            _card("ZTILE1", tx), _card("ZTILE2", ty), _card("ZCMPTYPE", "RICE_1"),
            _card("ZNAME1", "BLOCKSIZE"), _card("ZVAL1", 32),
            _card("ZNAME2", "BYTEPIX"), _card("ZVAL2", 4), b"END".ljust(80)]
    hdr = b"".join(ext)
    hdr += b" " * (-len(hdr) % 2880)
    body = bytes(table) + heap
    body += b"\0" * (-len(body) % 2880)
    with open(path, "wb") as f:
        f.write(prim + hdr + body)


@pytest.mark.parametrize("tile", [(37, 1), (16, 9)])
def test_tile_compressed_integer_image_reads_back(tmp_path, tile):
    """An int32 image in row tiles (fpack's default layout) and in ragged
    2-D tiles, values over the whole int32 range in one corner (raw
    high-entropy blocks)."""
    rng = np.random.default_rng(8)
    img = rng.integers(-3000, 3000, (23, 37)).astype(np.int32)
    img[:4, :6] = rng.integers(-2**31, 2**31, (4, 6), dtype=np.int64).astype(np.int32)
    img[10:14, 20:30] = 99
    path = str(tmp_path / "int.fits")
    write_tiled(path, img, tile)
    data, hdr = fits.read(path, ext=1)
    assert hdr["ZCMPTYPE"] == "RICE_1"
    # exact: the image itself is the oracle (sfft_tpu's reader drops bits
    # after the corner's raw blocks, REFERENCE_DROPS_BITS)
    np.testing.assert_array_equal(data, img.astype(np.float64))


@pytest.mark.parametrize("method", ["NO_DITHER", "SUBTRACTIVE_DITHER_1"])
def test_tile_compressed_float_image_reads_back(tmp_path, method):
    """A quantized float image (ZSCALE, ZZERO per tile), as fpack writes a
    difference image: within half a quantum of the original, and equal to
    sfft_tpu's reader."""
    rng = np.random.default_rng(9)
    img = rng.normal(0.0, 20.0, (30, 41))
    zscale, zzero = 0.05, -1.5
    path = str(tmp_path / "flt.fits")
    write_tiled(path, img, (41, 1), quantize=(zscale, zzero, method), dither0=3)
    data = fits.getdata(path, ext=1)
    assert data.shape == img.shape
    assert np.abs(data - img).max() <= 0.5 * zscale * (1 + 1e-9)
    import sfft_tpu  # noqa: F401
    from sfft_tpu.io import fits as jfits

    np.testing.assert_array_equal(data, jfits.getdata(path, ext=1))


# --- the card ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(PostAnomalyCheck=True, KerHWLimit=(2, 6)),
    dict(PostAnomalyCheck=True, KerHWLimit=(2, 6), cfg_overrides=dict(
        greek_backend="pexact", fdiff_backend="pexact", solver="exact")),
])
def test_esp_kernels_match_plain_twins_on_gpu(cuda, kw):
    """ESP at the golden pair's size on the card with the kernels against
    ESP on the card on the plain twins: solution within 1e-6 of its
    maximum, difference within 1e-8 max|J| (the contract trio: RMS < 1e-6),
    the same decisions and NaN mask."""
    from sfft_tpu_torch import EasySparsePacket

    paths = [os.path.join(DATA, f"golden_sparse_{s}.fits") for s in ("ref", "sci")]
    prep = EasySparsePacket.ESP_Prep(*paths, VERBOSE_LEVEL=0, **kw)
    runs = []
    for plain in (False, True):
        d, pd, sol, fs, _ = EasySparsePacket.ESP_Subtract(prep, *paths, VERBOSE_LEVEL=0,
                                                          plain=plain, device=cuda, **kw)
        # the check writes its columns into the prep's catalog: copy them
        runs.append((d, np.array(pd["SExCatalog-SubSource"]["MASK_PostAnomaly"]), sol, fs))
    (dk, mk, sk, fk), (dp, mp, sp, fp) = runs
    assert np.abs(sk - sp).max() <= 1e-6 * np.abs(sp).max()
    np.testing.assert_array_equal(np.isnan(dk), np.isnan(dp))
    J = prep["PixA_J"]
    if kw.get("cfg_overrides"):
        assert np.sqrt(np.nanmean((dk - dp) ** 2)) < 1e-6
    else:
        assert np.nanmax(np.abs(dk - dp)) <= 1e-8 * np.abs(J).max()
    np.testing.assert_array_equal(mk, mp)
    assert abs(fk - fp) <= 1e-6 * abs(fp)
