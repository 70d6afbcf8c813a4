"""Image I/O on numpy and zlib alone: PNG decode and encode, the two resizes
the loaders call, a baseline JPEG writer and reader, and the JET colormap.

The JAX package reads and writes images through PIL and colours depth maps
through cv2 (or matplotlib).  The port needs none of them:

* ``read_png`` / ``decode_png``: non-interlaced PNGs of 8 or 16 bits per
  sample, gray, gray + alpha, RGB or RGBA, all five row filters.  Arrays come
  out as ``np.asarray(PIL.Image.open(path))`` gives them: (h, w) for gray,
  (h, w, C) otherwise, uint8 or uint16.
* ``write_png`` / ``encode_png``: filter 0 on every row, zlib level 6.
* ``resize_lanczos``: Pillow's ``Image.resize(size, Image.LANCZOS)`` on
  uint8 images (``Resample.c``: separable passes, horizontal then vertical,
  coefficients in fixed point with 22 fractional bits, a uint8 result after
  each pass; RGBA and gray + alpha premultiplied around the passes, as
  Pillow resizes them in ``RGBa`` / ``La``).
* ``resize_nearest``: Pillow's ``Image.NEAREST`` (source index
  ``floor((i + 0.5) * in / out)``, summed step by step for 8-bit images).
* Both return a copy when the size does not change, as Pillow does.
* ``write_jpeg`` / ``encode_jpeg``: baseline JPEG of an RGB image, quality
  75, 4:2:0, the tables of ITU-T T.81 Annex K scaled as libjpeg scales them.
* ``read_jpeg`` / ``decode_jpeg``: baseline JPEG (what ``encode_jpeg`` and
  libjpeg write by default), chroma upsampled by repetition.
* ``JET_RGB``: cv2's ``COLORMAP_JET`` as a (256, 3) uint8 table in RGB order.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel

# ------------------------------------------------------------------ PNG


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> its pixels (see the module docstring)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour type {colour}, {depth} bits, "
                         f"interlace {interlace} (8/16-bit gray, gray+alpha, RGB, RGBA only)")
    channels = _PNG_CHANNELS[colour]
    bpp = channels * depth // 8  # bytes per pixel: the filters' left distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    px = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp))
    if depth == 16:
        px = px.reshape(h, w, channels, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]  # PNG stores samples big-endian
    px = px.reshape(h, w, channels)
    return px[..., 0] if channels == 1 else px


def _unfilter(kinds: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters.  ``filtered`` (h, w, bpp) bytes, ``kinds``
    (h,) filter types.  A byte depends on its left, upper and upper-left
    neighbours, so pixels are reconstructed one anti-diagonal (row + column)
    at a time, every row's filter at once."""
    if kinds.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(kinds.max())}")
    h, w, bpp = filtered.shape
    if not kinds.any():
        return filtered.copy()
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row above, a zero column left
    filt = filtered.astype(np.int16)
    kinds = kinds.astype(np.int16)
    for t in range(h + w - 1):
        rows = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        cols = t - rows
        a = out[rows + 1, cols]  # left
        b = out[rows, cols + 1]  # up
        c = out[rows, cols]  # up-left
        kind = kinds[rows][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[rows + 1, cols + 1] = (filt[rows, cols] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(h, w) or (h, w, C in 1-4) uint8 or uint16 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG pixels must be uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    colour = {v: k for k, v in _PNG_CHANNELS.items()}[channels]
    rows = img.astype(">u2" if img.dtype == np.uint16 else np.uint8).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, colour, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


# --------------------------------------------------------------- resizes

_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _lanczos(x: float) -> float:
    """Pillow's truncated sinc of support 3."""
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per output
    index the first source index and (out_size, ksize) fixed-point weights
    (zero past each window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in ws:
            ww += v
        for x, v in enumerate(ws):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int((-0.5 if k < 0 else 0.5) + k * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _lanczos_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of (h, w, C) uint8."""
    first, kk = _lanczos_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size, *src.shape[1:]), 1 << (_PRECISION_BITS - 1), np.int64)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), src.shape[0] - 1)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * kk[:, j].reshape(-1, *([1] * (src.ndim - 1)))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa (and LA -> La): colour x alpha / 255, rounded."""
    out = img.copy()
    alpha = img[..., -1:].astype(np.uint32)
    tmp = img[..., :-1].astype(np.uint32) * alpha + 128
    out[..., :-1] = ((tmp >> 8) + tmp) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA (and La -> LA): 255 x colour / alpha, truncated,
    where alpha is neither 0 nor 255."""
    out = img.copy()
    alpha = img[..., -1:].astype(np.uint32)
    scaled = np.minimum(255 * img[..., :-1].astype(np.uint32) // np.maximum(alpha, 1), 255)
    out[..., :-1] = np.where((alpha == 0) | (alpha == 255), img[..., :-1], scaled)
    return out


def resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """Pillow's LANCZOS resize of a uint8 (h, w) or (h, w, C) image to
    ``size`` = (w, h)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8 images, not {img.dtype}")
    w, h = int(size[0]), int(size[1])
    if (h, w) == img.shape[:2]:
        return img.copy()
    x = img[..., None] if img.ndim == 2 else img
    alpha = x.shape[-1] in (2, 4)
    if alpha:
        x = _premultiply(x)
    if w != x.shape[1]:
        x = _lanczos_pass(x, w, 1)
    if h != x.shape[0]:
        x = _lanczos_pass(x, h, 0)
    if alpha:
        x = _unpremultiply(x)
    return x[..., 0] if img.ndim == 2 else x


def _nearest_index(n_in: int, n_out: int, accumulate: bool) -> np.ndarray:
    scale = n_in / n_out
    if not accumulate:  # Geometry.c's generic affine transform
        return ((np.arange(n_out) + 0.5) * scale).astype(np.int64)
    idx, pos = [], 0.5 * scale  # ImagingScaleAffine: the position summed step by step
    for _ in range(n_out):
        idx.append(int(pos))
        pos += scale
    return np.array(idx, np.int64)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """Pillow's NEAREST resize to ``size`` = (w, h).  Pillow maps 16-bit
    images (``I;16``) through its generic transform and 8-bit ones through
    its scaling loop, whose source positions are running sums."""
    img = np.asarray(img)
    w, h = int(size[0]), int(size[1])
    if (h, w) == img.shape[:2]:
        return img.copy()
    accumulate = img.dtype != np.uint16
    ys = _nearest_index(img.shape[0], h, accumulate)
    xs = _nearest_index(img.shape[1], w, accumulate)
    return img[ys][:, xs]


# ------------------------------------------------------------------ JPEG

_Q_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_Q_CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32

# Huffman tables of T.81 Annex K.3: code counts per length 1-16, then symbols
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    cells = [(i, j) for i in range(8) for j in range(8)]
    cells.sort(key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([8 * i + j for i, j in cells])


ZIGZAG = _zigzag()


def quant_table(base, quality: int = 75) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table (natural order)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base, np.int64) * scale + 50) // 100, 1, 255)


def _huffman_codes(table):
    """{symbol: (code, length)} of a (counts, symbols) table (T.81 Annex C)."""
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)  # byte stuffing
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones
        return bytes(self.out)


def _dct_matrix() -> np.ndarray:
    c = np.array([[math.cos((2 * x + 1) * u * math.pi / 16) for x in range(8)]
                  for u in range(8)])
    c[0] *= math.sqrt(1 / 8)
    c[1:] *= math.sqrt(2 / 8)
    return c


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(H, W) samples, H and W multiples of 8 -> (H/8, W/8, 64) quantised DCT
    coefficients in zigzag order."""
    h, w = plane.shape
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128.0
    coef = np.einsum("ux,abxy,vy->abuv", _DCT, b, _DCT).reshape(h // 8, w // 8, 64)
    return np.round(coef / q.reshape(64)).astype(np.int64)[..., ZIGZAG]


def _size(v: int) -> int:
    return abs(v).bit_length()


def _put_value(bits: _BitWriter, v: int, size: int) -> None:
    if size:
        bits.put(v if v > 0 else v + (1 << size) - 1, size)


def _encode_block(bits, zz, prev_dc, dc_codes, ac_codes) -> int:
    dc = int(zz[0])
    diff = dc - prev_dc
    size = _size(diff)
    bits.put(*dc_codes[size])
    _put_value(bits, diff, size)
    run = 0
    nonzero = np.flatnonzero(zz[1:]) + 1
    last = 0
    for k in nonzero:
        run = k - last - 1
        while run > 15:
            bits.put(*ac_codes[0xF0])
            run -= 16
        v = int(zz[k])
        size = _size(v)
        bits.put(*ac_codes[(run << 4) | size])
        _put_value(bits, v, size)
        last = k
    if last < 63:
        bits.put(*ac_codes[0x00])
    return dc


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """(h, w, 3) uint8 RGB -> baseline JFIF bytes, 4:2:0."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode_jpeg takes an (h, w, 3) uint8 RGB image")
    h, w = rgb.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge").astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def sub(p):
        return p.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))

    q_luma, q_chroma = quant_table(_Q_LUMA, quality), quant_table(_Q_CHROMA, quality)
    yb = _blocks(y, q_luma)
    cbb, crb = _blocks(sub(cb), q_chroma), _blocks(sub(cr), q_chroma)
    dc_l, ac_l = _huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA)
    dc_c, ac_c = _huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA)

    bits = _BitWriter()
    prev = [0, 0, 0]
    for my in range(ph // 16):
        for mx in range(pw // 16):
            for dy in range(2):
                for dx in range(2):
                    prev[0] = _encode_block(bits, yb[2 * my + dy, 2 * mx + dx], prev[0], dc_l, ac_l)
            prev[1] = _encode_block(bits, cbb[my, mx], prev[1], dc_c, ac_c)
            prev[2] = _encode_block(bits, crb[my, mx], prev[2], dc_c, ac_c)

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    def dht(cls_id: int, table) -> bytes:
        counts, symbols = table
        return bytes([cls_id, *counts, *symbols])

    head = b"\xff\xd8" + segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += segment(0xFFDB, bytes([0, *q_luma[ZIGZAG]]) + bytes([1, *q_chroma[ZIGZAG]]))
    head += segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                    + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    head += segment(0xFFC4, dht(0x00, _DC_LUMA) + dht(0x10, _AC_LUMA)
                    + dht(0x01, _DC_CHROMA) + dht(0x11, _AC_CHROMA))
    head += segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + bits.flush() + b"\xff\xd9"


def write_jpeg(path, rgb: np.ndarray, quality: int = 75) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(rgb, quality))


def _huffman_lookup(counts, symbols):
    """A 16-bit look-ahead table: ``table[bits] = (symbol, code length)``."""
    table = [None] * 65536
    for sym, (code, length) in _huffman_codes((counts, symbols)).items():
        lo = code << (16 - length)
        for i in range(lo, lo + (1 << (16 - length))):
            table[i] = (sym, length)
    return table


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (h, w, 3) uint8 RGB (or (h, w) for one
    component).  Sequential Huffman coding only, no restart intervals; the
    chroma planes are upsampled by repetition, so the pixels lie within a
    few levels of libjpeg's."""
    pos, qt, tables, frame = 2, {}, {}, None
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    while True:
        marker, length = struct.unpack(">HH", data[pos:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xFFDB:
            for i in range(0, len(body), 65):
                if body[i] >> 4:
                    raise ValueError("16-bit quantisation tables are not supported")
                qt[body[i] & 15] = np.array(list(body[i + 1:i + 65]))[np.argsort(ZIGZAG)]
        elif marker == 0xFFC4:
            i = 0
            while i < len(body):
                counts = body[i + 1:i + 17]
                tables[body[i]] = _huffman_lookup(counts, body[i + 17:i + 17 + sum(counts)])
                i += 17 + sum(counts)
        elif marker in (0xFFC0, 0xFFC1):
            _, h, w, nc = struct.unpack(">BHHB", body[:6])
            frame = [(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                      body[8 + 3 * k]) for k in range(nc)]
        elif marker == 0xFFDD:
            raise ValueError("restart intervals are not supported")
        elif marker in (0xFFC2, 0xFFC3) or 0xFFC5 <= marker <= 0xFFCF and marker != 0xFFC8:
            raise ValueError("only baseline JPEG is supported")
        elif marker == 0xFFDA:
            break
    sel = {body[1 + 2 * k]: body[2 + 2 * k] for k in range(body[0])}
    end = data.index(b"\xff\xd9", pos) if b"\xff\xd9" in data[pos:] else len(data)
    scan = np.frombuffer(data[pos:end].replace(b"\xff\x00", b"\xff") + b"\x00\x00\x00",
                         np.uint8).astype(np.int64)
    w24 = ((scan[:-2] << 16) | (scan[1:-1] << 8) | scan[2:]).tolist()

    hmax, vmax = max(c[1] for c in frame), max(c[2] for c in frame)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = [np.zeros((mcuy * c[2], mcux * c[1], 64), np.int64) for c in frame]
    bitpos = 0
    prev = [0] * len(frame)

    def peek16():
        return (w24[bitpos >> 3] >> (8 - (bitpos & 7))) & 0xFFFF

    def receive(s):  # s <= 11 bits in baseline JPEG
        nonlocal bitpos
        if s == 0:
            return 0
        v = peek16() >> (16 - s)
        bitpos += s
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    def decode(table):
        nonlocal bitpos
        sym, length = table[peek16()]
        bitpos += length
        return sym

    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (cid, hs, vs, _) in enumerate(frame):
                dc_t, ac_t = tables[sel[cid] >> 4], tables[0x10 | (sel[cid] & 15)]
                for by in range(vs):
                    for bx in range(hs):
                        blk = coefs[ci][my * vs + by, mx * hs + bx]
                        prev[ci] += receive(decode(dc_t))
                        blk[0] = prev[ci]
                        k = 1
                        while k < 64:
                            rs = decode(ac_t)
                            if rs == 0:
                                break
                            k += rs >> 4
                            blk[k] = receive(rs & 15)
                            k += 1

    planes = []
    for ci, (cid, hs, vs, tq) in enumerate(frame):
        c = coefs[ci][..., np.argsort(ZIGZAG)] * qt[tq]
        c = c.reshape(*c.shape[:2], 8, 8)
        px = np.einsum("ux,abuv,vy->abxy", _DCT, c, _DCT) + 128.0
        px = px.transpose(0, 2, 1, 3).reshape(c.shape[0] * 8, c.shape[1] * 8)
        px = np.repeat(np.repeat(px, vmax // vs, axis=0), hmax // hs, axis=1)
        planes.append(px[:h, :w])
    if len(planes) == 1:
        return np.clip(np.round(planes[0]), 0, 255).astype(np.uint8)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    rgb = np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read())


# --------------------------------------------------------------- colormap

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET), BGR
# turned to RGB: 256 rows of 3 bytes
JET_RGB = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc"
    "0000c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff"
    "00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd232ffce36ffca3affc63effc2"
    "42ffbe46ffba4affb64effb252ffae56ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000"
    "ffbc00ffb800ffb400ffb000ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000ff4c00ff4800ff4400ff4000"
    "ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c0000880000840000800000"
), np.uint8).reshape(256, 3)
