"""Minimal pure-numpy FITS image I/O.

astropy is not available in this environment; the reference uses
astropy.io.fits purely for primary-HDU image reads/writes with simple headers
(e.g. sfft/CustomizedPacket.py:93-96, 190-221). This module implements that
subset: multi-HDU image read (primary + IMAGE extensions), BITPIX
8/16/32/64/-32/-64 with BSCALE/BZERO, and primary-HDU image writes with
user header cards.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

BLOCK = 2880

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


class Header(dict):
    """Ordered card dict with list-of-(key, value, comment) retention."""

    def __init__(self):
        super().__init__()
        self.cards: List[Tuple[str, object, str]] = []

    def add(self, key: str, value, comment: str = ""):
        self.cards.append((key, value, comment))
        if key not in ("COMMENT", "HISTORY", ""):
            self[key] = value

    def set(self, key: str, value, comment: str = ""):
        """Update an existing card in place (or append)."""
        if key in self:
            self.cards = [
                (k, value if k == key else v, c) for (k, v, c) in self.cards
            ]
            self[key] = value
        else:
            self.add(key, value, comment)


def _parse_value(raw: str):
    s = raw.strip()
    if not s:
        return None
    if s.startswith("'"):
        # FITS string: quotes doubled inside
        end = s.rfind("'")
        return s[1:end].replace("''", "'").rstrip()
    if s == "T":
        return True
    if s == "F":
        return False
    try:
        if any(c in s for c in ".EeDd") and not s.lstrip("+-").isdigit():
            return float(s.replace("D", "E").replace("d", "e"))
        return int(s)
    except ValueError:
        return s


def _read_header(f) -> Optional[Header]:
    hdr = Header()
    first = True
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            if first and not block:
                return None
            if not block.strip():
                return None
            raise IOError("truncated FITS header")
        first = False
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, BLOCK, 80):
            card = text[i : i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key and not card.strip():
                continue
            if key in ("COMMENT", "HISTORY"):
                hdr.add(key, card[8:].rstrip())
                continue
            if card[8:10] == "= ":
                body = card[10:]
                slash = _find_comment_slash(body)
                rawval = body[:slash] if slash >= 0 else body
                comment = body[slash + 1 :].strip() if slash >= 0 else ""
                hdr.add(key, _parse_value(rawval), comment)
            else:
                hdr.add(key, card[8:].rstrip())
        if done:
            return hdr


def _find_comment_slash(body: str) -> int:
    in_str = False
    i = 0
    while i < len(body):
        c = body[i]
        if c == "'":
            if in_str and i + 1 < len(body) and body[i + 1] == "'":
                i += 2
                continue
            in_str = not in_str
        elif c == "/" and not in_str:
            return i
        i += 1
    return -1


def _data_shape(hdr: Header) -> Tuple[int, ...]:
    naxis = int(hdr.get("NAXIS", 0))
    # FITS is Fortran order: NAXIS1 fastest -> numpy shape reversed
    return tuple(int(hdr[f"NAXIS{k}"]) for k in range(naxis, 0, -1))


def _read_hdu(f):
    hdr = _read_header(f)
    if hdr is None:
        return None
    shape = _data_shape(hdr)
    data = None
    if shape and all(s > 0 for s in shape):
        bitpix = int(hdr["BITPIX"])
        dt = _BITPIX_DTYPE[bitpix]
        nbytes = int(np.prod(shape)) * dt.itemsize
        # binary tables carry a heap of PCOUNT bytes after the main data
        heap_bytes = int(hdr.get("PCOUNT", 0) or 0)
        raw = f.read(nbytes + heap_bytes)
        if len(raw) < nbytes + heap_bytes:
            raise IOError("truncated FITS data")
        pad = (-(nbytes + heap_bytes)) % BLOCK
        f.seek(pad, os.SEEK_CUR)
        if hdr.get("ZIMAGE") is True:
            data = _decompress_tiled_image(hdr, raw[:nbytes], raw[nbytes:])
        else:
            data = np.frombuffer(raw[:nbytes], dtype=dt).reshape(shape)
            bscale = hdr.get("BSCALE", 1)
            bzero = hdr.get("BZERO", 0)
            if bscale != 1 or bzero != 0:
                data = data.astype(np.float64) * bscale + bzero
            else:
                data = data.astype(dt.newbyteorder("="))
    return hdr, data


_TFORM_SIZES = {"L": 1, "X": 0, "B": 1, "I": 2, "J": 4, "K": 8,
                "A": 1, "E": 4, "D": 8, "C": 8, "M": 16, "P": 8, "Q": 16}


def _parse_tform(tform: str):
    """Returns (repeat, typecode, bytesize)."""
    import re

    m = re.match(r"(\d*)([LXBIJKAEDCMPQ])", tform.strip())
    rep = int(m.group(1)) if m.group(1) else 1
    code = m.group(2)
    return rep, code, rep * _TFORM_SIZES[code]


def _fits_rand_values():
    """CFITSIO fits_init_randoms sequence (10000 uniform values)."""
    a, m = 16807.0, 2147483647.0
    seed = 1.0
    vals = np.empty(10000)
    for i in range(10000):
        temp = a * seed
        seed = temp - m * int(temp / m)
        vals[i] = seed / m
    return vals


_RAND_CACHE = {}


def _decompress_tiled_image(hdr: "Header", table: bytes, heap: bytes) -> np.ndarray:
    """Decompress a tiled-compressed image extension (fpack).

    Supports RICE_1 (BYTEPIX 4) and GZIP_1 codecs, NO_DITHER /
    SUBTRACTIVE_DITHER_1 quantization (CFITSIO conventions).
    """
    from sfft_tpu_torch import native

    zbitpix = int(hdr["ZBITPIX"])
    znaxis = int(hdr["ZNAXIS"])
    zdims = [int(hdr[f"ZNAXIS{k}"]) for k in range(1, znaxis + 1)]  # (x, y)
    tile = [int(hdr.get(f"ZTILE{k}", zdims[0] if k == 1 else 1) or 1)
            for k in range(1, znaxis + 1)]
    cmptype = str(hdr.get("ZCMPTYPE", "RICE_1")).strip()
    quantiz = str(hdr.get("ZQUANTIZ", "NO_DITHER")).strip()
    dither0 = int(hdr.get("ZDITHER0", 0) or 0)
    blocksize = 32
    bytepix = 4
    for k in range(1, 10):
        name = hdr.get(f"ZNAME{k}")
        if name is None:
            break
        if str(name).strip() == "BLOCKSIZE":
            blocksize = int(hdr[f"ZVAL{k}"])
        if str(name).strip() == "BYTEPIX":
            bytepix = int(hdr[f"ZVAL{k}"])

    nrows = int(hdr["NAXIS2"])
    rowlen = int(hdr["NAXIS1"])
    tfields = int(hdr["TFIELDS"])
    offsets = []
    pos = 0
    cols = {}
    for k in range(1, tfields + 1):
        tform = str(hdr[f"TFORM{k}"])
        ttype = str(hdr.get(f"TTYPE{k}", "")).strip()
        rep, code, size = _parse_tform(tform)
        cols[ttype] = (pos, rep, code)
        pos += size
    tab = np.frombuffer(table, dtype=np.uint8).reshape(nrows, rowlen)

    def col_desc(name):
        off, rep, code = cols[name]
        if code == "P":  # variable-length descriptor: (nelem, heap offset)
            d = tab[:, off : off + 8].tobytes()
            arr = np.frombuffer(d, dtype=">i4").reshape(nrows, 2)
            return arr
        if code == "D":
            d = tab[:, off : off + 8].tobytes()
            return np.frombuffer(d, dtype=">f8")
        raise ValueError(code)

    desc = col_desc("COMPRESSED_DATA")
    zscale = col_desc("ZSCALE") if "ZSCALE" in cols else np.ones(nrows)
    zzero = col_desc("ZZERO") if "ZZERO" in cols else np.zeros(nrows)

    # tile raster: ZTILE1 across x (fastest), etc.
    ntiles = []
    for d, t in zip(zdims, tile):
        ntiles.append(-(-d // t))
    npix_tile_full = int(np.prod(tile))

    if "SUBTRACTIVE_DITHER" in quantiz:
        if "seq" not in _RAND_CACHE:
            _RAND_CACHE["seq"] = _fits_rand_values()
        rand = _RAND_CACHE["seq"]
    else:
        rand = None

    out = np.zeros(list(reversed(zdims)), dtype=np.float64)  # (y, x)
    NULL32 = -2147483647
    for n in range(nrows):
        nelem, hoff = int(desc[n, 0]), int(desc[n, 1])
        stream = heap[hoff : hoff + nelem]
        # tile extents (handle ragged edge tiles)
        tx = n % ntiles[0]
        ty = (n // ntiles[0]) % (ntiles[1] if znaxis > 1 else 1)
        sx = min(tile[0], zdims[0] - tx * tile[0])
        sy = min(tile[1], zdims[1] - ty * tile[1]) if znaxis > 1 else 1
        npix = sx * sy
        if cmptype == "RICE_1":
            assert bytepix == 4, "only BYTEPIX=4 RICE implemented"
            ints = native.rice_decode(stream, npix, blocksize)
        elif cmptype.startswith("GZIP"):
            import zlib

            rawb = zlib.decompress(stream)
            ints = np.frombuffer(rawb, dtype=">i4").astype(np.int32)
        else:
            raise ValueError(f"unsupported ZCMPTYPE {cmptype!r}")

        if zbitpix < 0:  # quantized float image
            vals = np.empty(npix, dtype=np.float64)
            if rand is not None:
                iseed = (n + dither0 - 1) % 10000
                nextrand = int(rand[iseed] * 500.0)
                idx = np.arange(npix)
                # vectorized walk of the dither sequence
                seq = np.empty(npix)
                j = nextrand
                isd = iseed
                # the sequence advances by 1 per pixel with block reseed
                steps = np.arange(npix) + nextrand
                wraps = steps // 10000
                if wraps.max() == 0:
                    seq = rand[(steps) % 10000]
                else:
                    # rare: walk explicitly
                    for t in range(npix):
                        seq[t] = rand[j]
                        j += 1
                        if j == 10000:
                            isd = (isd + 1) % 10000
                            j = int(rand[isd] * 500.0)
                vals = (ints.astype(np.float64) - seq + 0.5) * zscale[n] + zzero[n]
            else:
                vals = ints.astype(np.float64) * zscale[n] + zzero[n]
            vals[ints == NULL32] = np.nan
        else:
            vals = ints.astype(np.float64) * zscale[n] + zzero[n]

        block = vals.reshape(sy, sx)
        y0 = ty * tile[1] if znaxis > 1 else 0
        x0 = tx * tile[0]
        out[y0 : y0 + sy, x0 : x0 + sx] = block
    return out


def read(path: str, ext: int = 0) -> Tuple[np.ndarray, Header]:
    """Read image data + header of HDU `ext` (0 = primary)."""
    with open(path, "rb") as f:
        idx = 0
        while True:
            hdu = _read_hdu(f)
            if hdu is None:
                raise IndexError(f"HDU {ext} not found in {path}")
            if idx == ext:
                hdr, data = hdu
                return data, hdr
            idx += 1


def getdata(path: str, ext: int = 0) -> np.ndarray:
    return read(path, ext)[0]


def getheader(path: str, ext: int = 0) -> Header:
    return read(path, ext)[1]


def _format_card(key: str, value, comment: str = "") -> bytes:
    if key in ("COMMENT", "HISTORY"):
        card = f"{key:<8}{str(value)[:72]}"
    else:
        if isinstance(value, bool):
            v = "T" if value else "F"
            field = f"{v:>20}"
        elif isinstance(value, (int, np.integer)):
            field = f"{int(value):>20}"
        elif isinstance(value, (float, np.floating)):
            field = f"{float(value):>20.13G}"
        elif value is None:
            field = " " * 20
        else:
            s = str(value).replace("'", "''")
            field = f"'{s:<8}'"
        card = f"{key:<8}= {field}"
        if comment:
            card += f" / {comment}"
    return card[:80].ljust(80).encode("ascii")


def write(
    path: str,
    data: np.ndarray,
    header: Optional[Union[Header, Dict]] = None,
    overwrite: bool = True,
):
    """Write a primary-HDU image FITS file."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    data = np.asarray(data)
    if data.dtype == np.float64:
        bitpix, odt = -64, np.dtype(">f8")
    elif data.dtype == np.float32:
        bitpix, odt = -32, np.dtype(">f4")
    elif data.dtype in (np.int16,):
        bitpix, odt = 16, np.dtype(">i2")
    elif data.dtype in (np.int32,):
        bitpix, odt = 32, np.dtype(">i4")
    elif data.dtype in (np.int64,):
        bitpix, odt = 64, np.dtype(">i8")
    elif data.dtype == bool:
        data = data.astype(np.int16)
        bitpix, odt = 16, np.dtype(">i2")
    else:
        data = data.astype(np.float64)
        bitpix, odt = -64, np.dtype(">f8")

    cards = [
        _format_card("SIMPLE", True, "conforms to FITS standard"),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", data.ndim),
    ]
    for k, n in enumerate(reversed(data.shape), start=1):
        cards.append(_format_card(f"NAXIS{k}", n))

    reserved = {"SIMPLE", "BITPIX", "NAXIS"} | {f"NAXIS{k}" for k in range(1, 10)}
    if header is not None:
        items = header.cards if isinstance(header, Header) else [
            (k, v, "") for k, v in header.items()
        ]
        for key, value, *rest in items:
            if key in reserved:
                continue
            comment = rest[0] if rest else ""
            cards.append(_format_card(key, value, comment))
    cards.append(b"END".ljust(80))

    hdr_bytes = b"".join(cards)
    hdr_bytes += b" " * ((-len(hdr_bytes)) % BLOCK)
    body = data.astype(odt).tobytes()
    body += b"\x00" * ((-len(body)) % BLOCK)
    with open(path, "wb") as f:
        f.write(hdr_bytes)
        f.write(body)

# ---------------------------------------------------------------------------
# Binary tables (BINTABLE) and SExtractor FITS_LDAC catalogs
# ---------------------------------------------------------------------------
# Reference consumer: sfft/utils/pyAstroMatic/PYSEx.py parses the FITS_LDAC
# catalogs written by the SExtractor binary (LDAC_IMHEAD extension carrying
# the image header as 80-char cards + LDAC_OBJECTS extension with the
# measurement columns).

_TCODE_BE = {"L": "S1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
             "A": "S1", "E": ">f4", "D": ">f8"}


def _parse_bintable(hdr: Header, raw: bytes):
    """Parse one BINTABLE HDU's fixed-width columns -> {name: ndarray}."""
    nrows = int(hdr.get("NAXIS2", 0))
    rowlen = int(hdr.get("NAXIS1", 0))
    tfields = int(hdr.get("TFIELDS", 0))
    tab = np.frombuffer(raw[: nrows * rowlen], dtype=np.uint8)
    tab = tab.reshape(nrows, rowlen)
    cols = {}
    pos = 0
    for k in range(1, tfields + 1):
        tform = str(hdr[f"TFORM{k}"]).strip()
        name = str(hdr.get(f"TTYPE{k}", f"COL{k}")).strip()
        rep, code, size = _parse_tform(tform)
        chunk = tab[:, pos : pos + size].tobytes()
        pos += size
        if code in ("P", "Q", "X", "C", "M"):
            cols[name] = np.frombuffer(chunk, dtype=np.uint8).reshape(nrows, size)
            continue
        if code == "A":
            arr = np.array([chunk[i * rep : (i + 1) * rep].decode(
                "ascii", errors="replace").rstrip() for i in range(nrows)])
        else:
            arr = np.frombuffer(chunk, dtype=_TCODE_BE[code])
            if code == "L":
                arr = (arr == b"T")
            else:
                arr = arr.astype(arr.dtype.newbyteorder("="))
            if rep > 1:
                arr = arr.reshape(nrows, rep)
        cols[name] = arr
    return cols


def read_table(path: str, ext: Optional[int] = None,
               extname: Optional[str] = None):
    """Read a BINTABLE extension -> ({column: ndarray}, Header).

    Select by HDU index `ext` or by EXTNAME; default: first BINTABLE found.
    """
    with open(path, "rb") as f:
        idx = 0
        while True:
            hdr = _read_header(f)
            if hdr is None:
                raise IndexError(f"table HDU not found in {path}")
            shape = _data_shape(hdr)
            nbytes = 0
            if shape and all(s > 0 for s in shape):
                bitpix = int(hdr["BITPIX"])
                nbytes = int(np.prod(shape)) * _BITPIX_DTYPE[bitpix].itemsize
            heap = int(hdr.get("PCOUNT", 0) or 0)
            total = nbytes + heap
            is_table = str(hdr.get("XTENSION", "")).strip() == "BINTABLE"
            want = (ext == idx if ext is not None else
                    (str(hdr.get("EXTNAME", "")).strip() == extname
                     if extname is not None else is_table))
            if want and is_table:
                raw = f.read(total)
                return _parse_bintable(hdr, raw), hdr
            f.seek(total + ((-total) % BLOCK), os.SEEK_CUR)
            idx += 1


def _table_tform(arr: np.ndarray):
    """(TFORM string, big-endian encoder) for one column array."""
    if arr.dtype.kind in ("U", "S"):
        width = int(arr.dtype.itemsize // (4 if arr.dtype.kind == "U" else 1))
        width = max(width, 1)
        def enc(a):
            return np.array([s.encode("ascii", errors="replace")[:width]
                             if isinstance(s, str) else bytes(s)[:width]
                             for s in a], dtype=f"S{width}")
        return f"{width}A", enc
    rep = 1 if arr.ndim == 1 else int(np.prod(arr.shape[1:]))
    kind = arr.dtype.kind
    if kind == "b":
        return f"{rep}L", lambda a: np.where(a, b"T", b"F").astype("S1")
    if kind == "u" and arr.dtype.itemsize > 1:
        return f"{rep}K", lambda a: a.astype(">i8")  # widen unsigned
    code, dt = {("i", 2): ("I", ">i2"), ("i", 4): ("J", ">i4"),
                ("i", 8): ("K", ">i8"), ("u", 1): ("B", ">u1"),
                ("f", 4): ("E", ">f4"), ("f", 8): ("D", ">f8")}.get(
        (kind, arr.dtype.itemsize), ("D", ">f8"))
    return f"{rep}{code}", lambda a: a.astype(dt)


def _bintable_hdu_bytes(columns, extname: str,
                        header: Optional[Header] = None) -> bytes:
    names = list(columns)
    nrows = len(np.asarray(columns[names[0]])) if names else 0
    rowparts, tforms = [], []
    for n in names:
        arr = np.asarray(columns[n])
        tform, enc = _table_tform(arr)
        size = _parse_tform(tform)[2]
        e = np.ascontiguousarray(enc(arr))
        rowparts.append(e.view(np.uint8).reshape(nrows, size))
        tforms.append(tform)
    rowlen = sum(p.shape[1] for p in rowparts)
    body = (np.concatenate(rowparts, axis=1).tobytes()
            if rowparts and nrows else b"")

    cards = [
        _format_card("XTENSION", "BINTABLE", "binary table extension"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowlen),
        _format_card("NAXIS2", nrows),
        _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(names)),
        _format_card("EXTNAME", extname),
    ]
    for k, (n, tf) in enumerate(zip(names, tforms), start=1):
        cards.append(_format_card(f"TTYPE{k}", n))
        cards.append(_format_card(f"TFORM{k}", tf))
    if header is not None:
        skip = {"XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
                "GCOUNT", "TFIELDS", "EXTNAME"}
        for key, value, comment in header.cards:
            if key in skip or key.startswith(("TTYPE", "TFORM")):
                continue
            cards.append(_format_card(key, value, comment))
    cards.append(b"END".ljust(80))
    hdrb = b"".join(cards)
    hdrb += b" " * ((-len(hdrb)) % BLOCK)
    body += b"\x00" * ((-len(body)) % BLOCK)
    return hdrb + body


def _primary_stub_bytes() -> bytes:
    cards = [_format_card("SIMPLE", True), _format_card("BITPIX", 8),
             _format_card("NAXIS", 0), _format_card("EXTEND", True),
             b"END".ljust(80)]
    b = b"".join(cards)
    return b + b" " * ((-len(b)) % BLOCK)


def write_table(path: str, columns, extname: str = "TABLE",
                header: Optional[Header] = None):
    """Write {column: ndarray} as primary stub + one BINTABLE extension."""
    with open(path, "wb") as f:
        f.write(_primary_stub_bytes())
        f.write(_bintable_hdu_bytes(columns, extname, header))


def _header_to_cardblock(hdr: Header) -> np.ndarray:
    cards = [_format_card(k, v, c).decode("ascii") for (k, v, c) in hdr.cards]
    cards.append("END".ljust(80))
    return np.array(cards)


def _cardblock_to_header(cards) -> Header:
    hdr = Header()
    for card in cards:
        card = str(card).ljust(80)[:80]
        key = card[:8].strip()
        if key == "END":
            break
        if not key and not card.strip():
            continue
        if key in ("COMMENT", "HISTORY"):
            hdr.add(key, card[8:].rstrip())
        elif card[8:10] == "= ":
            body = card[10:]
            slash = _find_comment_slash(body)
            rawval = body[:slash] if slash >= 0 else body
            comment = body[slash + 1 :].strip() if slash >= 0 else ""
            hdr.add(key, _parse_value(rawval), comment)
        else:
            hdr.add(key, card[8:].rstrip())
    return hdr


def write_ldac(path: str, columns, imheader: Optional[Header] = None):
    """Write a SExtractor-convention FITS_LDAC catalog: primary stub +
    LDAC_IMHEAD (the image header as one 80-char-card string column) +
    LDAC_OBJECTS (the measurement table)."""
    if imheader is None:
        imheader = Header()
        imheader.add("SIMPLE", True)
    cardblock = _header_to_cardblock(imheader)
    field = np.array(["".join(c.ljust(80) for c in cardblock)])
    with open(path, "wb") as f:
        f.write(_primary_stub_bytes())
        f.write(_bintable_hdu_bytes(
            {"Field Header Card": field}, "LDAC_IMHEAD"))
        f.write(_bintable_hdu_bytes(columns, "LDAC_OBJECTS"))


def read_ldac(path: str):
    """Read a FITS_LDAC catalog -> ({column: ndarray}, image Header).

    Accepts both proper LDAC files (LDAC_IMHEAD + LDAC_OBJECTS) and plain
    FITS_1.0 catalogs (single BINTABLE, empty image header)."""
    try:
        imh_cols, _ = read_table(path, extname="LDAC_IMHEAD")
        blob = str(list(imh_cols.values())[0][0])
        cards = [blob[i : i + 80] for i in range(0, len(blob), 80)]
        imhdr = _cardblock_to_header(cards)
    except IndexError:
        imhdr = Header()
    try:
        cols, _ = read_table(path, extname="LDAC_OBJECTS")
    except IndexError:
        cols, _ = read_table(path)
    return cols, imhdr
