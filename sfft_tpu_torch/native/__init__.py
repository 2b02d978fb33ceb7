"""Native host kernels of the preprocessing, with their numpy twins.

One C++ CPython extension (``_native.cc``, a copy of sfft_tpu's) holds the
three host loops of the automatic pipelines: the straight-line Hough
accumulator, the connected-component labeller of the source extractor and
the RICE_1 decoder of tile-compressed FITS. It is compiled with g++ at its
first use into ``sfft_tpu_torch/_build/native/``, under a name that carries
a hash of the source and the flags, so an edited source builds anew. The
compiler writes a temporary file that is then renamed into place, so
processes that build at the same time never load a half-written library.

Each entry point has a numpy twin (``*_numpy``) with the same results. The
entry points run the twin only where the extension cannot be built or
loaded, and say so once on stderr; ``available()`` tells a caller which one
runs (``chip_smoke.py`` requires the extension).

Nothing here imports torch, and nothing is built at import.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_native = None
_tried = False
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(np.__version__.encode() + sys.version.encode())
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"_native_{h.hexdigest()[:16]}{ext}")


def build() -> str:
    """Compile the extension unless it exists for this source; return its
    path. The library is written under a temporary name and renamed."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, f"-I{sysconfig.get_path('include')}",
               f"-I{np.get_include()}", SOURCE, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(path: str):
    # the module's init function is PyInit__native, so its name ends in
    # "_native"; the package prefix keeps it apart from sfft_tpu's extension
    name = __name__ + "._native"
    loader = importlib.machinery.ExtensionFileLoader(name, path)
    spec = importlib.util.spec_from_file_location(name, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _try_load():
    global _native, _tried
    if _tried:
        return _native
    with _lock:
        if not _tried:
            try:
                _native = _load(build())
            except Exception as exc:  # toolchain-dependent
                sys.stderr.write(f"sfft_tpu_torch.native: extension unavailable ({exc}); "
                                 "the numpy twins run instead\n")
                _native = None
            _tried = True
    return _native


def available() -> bool:
    """True when the C++ extension is built and loaded (building it now if
    it has not been tried)."""
    return _try_load() is not None


def hough_accum(x_idxs, y_idxs, ctheta, stheta, max_distance) -> np.ndarray:
    mod = _try_load()
    if mod is None:
        return hough_accum_numpy(x_idxs, y_idxs, ctheta, stheta, max_distance)
    return mod.hough_accum(
        np.ascontiguousarray(x_idxs, np.int64),
        np.ascontiguousarray(y_idxs, np.int64),
        np.ascontiguousarray(ctheta, np.float64),
        np.ascontiguousarray(stheta, np.float64),
        int(max_distance),
    )


def hough_accum_numpy(x_idxs, y_idxs, ctheta, stheta, max_distance) -> np.ndarray:
    """Vectorised scatter-add with half-away-from-zero rounding."""
    x = np.asarray(x_idxs, np.float64)[:, None]
    y = np.asarray(y_idxs, np.float64)[:, None]
    v = ctheta[None, :] * x + stheta[None, :] * y
    idx = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(np.int64)
    idx += max_distance // 2
    accum = np.zeros((max_distance, len(ctheta)), dtype=np.uint64)
    j = np.broadcast_to(np.arange(len(ctheta))[None, :], idx.shape)
    ok = (idx >= 0) & (idx < max_distance)
    np.add.at(accum, (idx[ok], j[ok]), 1)
    return accum


def label(mask, connectivity: int = 2):
    """Connected-component labeling; returns (labels int32, nlabels)."""
    mod = _try_load()
    if mod is None:
        return label_numpy(mask, connectivity)
    m = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    return mod.ccl_label(m, int(connectivity))


def label_numpy(mask, connectivity: int = 2):
    from scipy import ndimage

    m = np.asarray(mask) != 0
    structure = np.ones((3, 3)) if connectivity == 2 else None
    lab, n = ndimage.label(m, structure=structure)
    return lab.astype(np.int32), int(n)


def rice_decode(data: bytes, npix: int, blocksize: int = 32) -> np.ndarray:
    """RICE_1 decode (BYTEPIX=4) -> int32[npix]; CFITSIO fits_rdecomp
    semantics."""
    mod = _try_load()
    if mod is None:
        return rice_decode_numpy(data, npix, blocksize)
    return mod.rice_decode(bytes(data), int(npix), int(blocksize))


def _wrap32(v: int) -> int:
    """v as a two's-complement int32 (the C++ decoder's int32 arithmetic)."""
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def rice_decode_numpy(data: bytes, npix: int, blocksize: int = 32) -> np.ndarray:
    """The decoder in Python, step for step the C++ one (int32 sums wrap)."""
    if len(data) < 4:
        raise ValueError("rice stream too short")
    out = np.zeros(npix, dtype=np.int32)
    fsbits, fsmax, bbits = 5, 25, 32
    c = np.frombuffer(data, dtype=np.uint8)
    n = len(c)
    lastpix = int.from_bytes(bytes(data[:4]), "big", signed=True)
    pos = 4

    def nextbyte():
        nonlocal pos
        v = int(c[pos]) if pos < n else 0
        pos += 1
        return v

    b = nextbyte()
    nbits = 8
    i = 0
    while i < npix:
        nbits -= fsbits
        while nbits < 0:
            b = (b << 8) | nextbyte()
            nbits += 8
        fs = ((b >> nbits) & ((1 << fsbits) - 1)) - 1
        b &= (1 << nbits) - 1
        imax = min(i + blocksize, npix)
        if fs < 0:
            out[i:imax] = lastpix
            i = imax
        elif fs == fsmax:
            while i < imax:
                k = bbits - nbits
                diff = (b << k) & 0xFFFFFFFF if k < 32 else 0
                k -= 8
                while k >= 0:
                    b = nextbyte()
                    diff |= b << k
                    k -= 8
                if nbits > 0:
                    b = nextbyte()
                    diff |= b >> (-k)
                    b &= (1 << nbits) - 1
                else:
                    b = 0
                d = ~(diff >> 1) if (diff & 1) else (diff >> 1)
                lastpix = _wrap32(d + lastpix)
                out[i] = lastpix
                i += 1
        else:
            while i < imax:
                while b == 0:
                    if pos >= n:
                        raise ValueError("rice stream exhausted")
                    nbits += 8
                    b = nextbyte()
                msb = b.bit_length() - 1
                nzero = nbits - (msb + 1)
                nbits = msb
                b &= (1 << nbits) - 1
                nbits -= fs
                while nbits < 0:
                    b = (b << 8) | nextbyte()
                    nbits += 8
                diff = ((nzero << fs) | (b >> nbits)) & 0xFFFFFFFF
                b &= (1 << nbits) - 1
                d = ~(diff >> 1) if (diff & 1) else (diff >> 1)
                lastpix = _wrap32(d + lastpix)
                out[i] = lastpix
                i += 1
    return out
