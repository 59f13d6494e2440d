"""PNG decoding and encoding with the standard library's ``zlib`` and
``struct`` plus numpy: the port reads capture frames and depth maps, and
writes eval images, with no imaging library.

Decoding covers what captures hold: bit depths 8 and 16 for grey, grey with
alpha, RGB and RGBA, palette images of 1, 2, 4 or 8 bits, and ``tRNS``
transparency. Adam7-interlaced files raise ``NotImplementedError``.

- :func:`read_png` gives the array PIL's ``np.asarray(Image.open(path))``
  gives: 16-bit grey keeps its 16-bit values (a depth map), 16-bit colour
  keeps the high byte of each sample, a palette image gives its indices.
- :func:`read_png_rgba` gives PIL's ``convert("RGBA")``: grey is
  replicated, alpha is 255 where the file has none, ``tRNS`` makes the
  matching pixels transparent, 16-bit grey saturates at 255.

Unfiltering is vectorised. Sub, Average and Paeth need the decoded pixel
to the left, so rows are undone as a wavefront over anti-diagonals: pixel
(r, x) needs only (r, x − 1), (r − 1, x) and (r − 1, x − 1), so each
diagonal is one vector step in which every row applies its own filter,
H + W steps an image.
:func:`decode_png_files` runs one wavefront over several files of one
shape at once: numpy's per-step cost is then shared, where threads that
each run their own wavefront would contend for the GIL.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from numpy.lib.stride_tricks import as_strided

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples a pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → colour type (no palette)
# files unfiltered in one wavefront: 8 frames of 800×800 RGBA hold about
# 160 MB of skewed int16 arrays
BATCH = 8


class _Png:
    """A decoded file: header fields, the (H, W, C) samples (uint8, or
    uint16 at depth 16; palette indices for colour type 3), the palette
    (K, 3) and the ``tRNS`` payload, if any."""

    def __init__(self, width, height, depth, color_type, samples, palette, trns):
        self.width, self.height = width, height
        self.depth, self.color_type = depth, color_type
        self.samples, self.palette, self.trns = samples, palette, trns


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: truncated (no IEND chunk)")


def _paeth(a, b, c):
    """The Paeth predictor of int16 left ``a``, up ``b``, up-left ``c``."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _skewed(buf: np.ndarray, B: int, H: int, W: int, bpp: int, first: int) -> np.ndarray:
    """A (B, H, W, bpp) view of the skewed array ``buf`` (D, H + 1, B, bpp)
    whose [b, r, x] is ``buf[first + r + x, r + 1, b]``."""
    e, rb = buf.itemsize, B * bpp
    return as_strided(buf.reshape(-1)[(first * (H + 1) + 1) * rb:], shape=(B, H, W, bpp),
                      strides=(e * bpp, e * (H + 2) * rb, e * (H + 1) * rb, e))


def _unfilter(filt: np.ndarray, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of a batch of B images of one shape: ``filt``
    (B, H) filter types, ``raw`` (B, H, stride) filtered bytes. A wavefront
    over the anti-diagonals of the (H, W) pixel grid (W = stride / bpp):
    each diagonal is one vector step over all rows of all images.
    The grid is held skewed: element [d + 1, r + 1, b] is pixel (r, d − r)
    of image b, so diagonal d is one contiguous slice, and the neighbours
    (r, x − 1), (r − 1, x), (r − 1, x − 1) of its pixels are slices of
    diagonals d − 1 and d − 2. Row 0 of the skewed array and every pixel
    outside the image stay 0, as the filters' edge rule asks."""
    B, H, stride = raw.shape
    W = stride // bpp
    n_diag = H + W - 1
    rb = B * bpp  # one skewed row: every image's pixel
    S = (H + 1) * rb
    skew_raw = np.zeros((n_diag, H + 1, B, bpp), np.int16)
    _skewed(skew_raw, B, H, W, bpp, 0)[...] = raw.reshape(B, H, W, bpp)
    skew_raw = skew_raw.reshape(n_diag, S)
    skew = np.zeros((n_diag + 1, H + 1, B, bpp), np.int16)
    flat = skew.reshape(n_diag + 1, S)
    kind = np.zeros((H + 1, B, bpp), np.int8)
    kind[1:] = filt.T[:, :, None]
    kind = kind.reshape(-1)
    m1, m2, m3, m4 = (kind == k for k in (1, 2, 3, 4))
    # elements of each filter before a skewed position: skip the Average
    # and Paeth arithmetic on diagonals whose rows use neither
    n3 = np.concatenate([[0], np.cumsum(m3)])
    n4 = np.concatenate([[0], np.cumsum(m4)])
    zero = np.zeros(S, np.int16)
    for d in range(n_diag):
        lo = (max(0, d - W + 1) + 1) * rb
        hi = (min(H - 1, d) + 2) * rb
        a = flat[d, lo:hi]  # left: diagonal d − 1, same row
        b = flat[d, lo - rb:hi - rb]  # up: diagonal d − 1, row above
        pred = np.where(m1[lo:hi], a, 0).astype(np.int16)
        np.copyto(pred, b, where=m2[lo:hi])
        if n3[hi] != n3[lo]:
            np.copyto(pred, (a + b) >> 1, where=m3[lo:hi])
        if n4[hi] != n4[lo]:
            c = flat[d - 1, lo - rb:hi - rb] if d > 0 else zero[lo:hi]  # up-left
            np.copyto(pred, _paeth(a, b, c), where=m4[lo:hi])
        pred += skew_raw[d, lo:hi]
        pred &= 0xFF
        flat[d + 1, lo:hi] = pred
    return _skewed(skew, B, H, W, bpp, 1).astype(np.uint8).reshape(B, H, stride)


class _Inflated:
    """A file parsed and inflated, its rows still filtered."""

    def __init__(self, name, header, palette, trns, data):
        width, height, depth, color_type, _, _, interlace = header
        if interlace:
            raise NotImplementedError(f"{name}: Adam7-interlaced PNG is not supported")
        if color_type not in _CHANNELS:
            raise ValueError(f"{name}: unknown colour type {color_type}")
        allowed = (1, 2, 4, 8) if color_type == 3 else (8, 16)
        if depth not in allowed:
            raise NotImplementedError(
                f"{name}: bit depth {depth} of colour type {color_type} is not supported")
        if color_type == 3 and palette is None:
            raise ValueError(f"{name}: palette image without PLTE")
        channels = _CHANNELS[color_type]
        self.stride = (width * channels * depth + 7) // 8
        self.bpp = max(1, channels * depth // 8)
        buf = np.frombuffer(zlib.decompress(data), np.uint8)
        if buf.size < height * (self.stride + 1):
            raise ValueError(f"{name}: image data too short")
        self.rows = buf[:height * (self.stride + 1)].reshape(height, self.stride + 1)
        if self.rows[:, 0].max(initial=0) > 4:
            raise ValueError(f"{name}: unknown filter type {int(self.rows[:, 0].max())}")
        self.width, self.height, self.depth = width, height, depth
        self.color_type, self.channels = color_type, channels
        self.palette, self.trns = palette, trns

    @property
    def shape_key(self) -> tuple:
        return self.height, self.stride, self.bpp

    def finish(self, rows: np.ndarray) -> _Png:
        """The decoded file from its unfiltered (H, stride) rows."""
        h, w, depth = self.height, self.width, self.depth
        if depth == 16:
            samples = rows.view(">u2").astype(np.uint16).reshape(h, w, self.channels)
        elif depth == 8:
            samples = rows.reshape(h, w, self.channels)
        else:  # palette indices packed several to a byte, high bits first
            bits_all = np.unpackbits(rows, axis=1)[:, :w * depth]
            weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
            samples = (bits_all.reshape(h, w, depth) * weights).sum(
                -1, dtype=np.uint8)[..., None]
        return _Png(w, h, depth, self.color_type, samples, self.palette, self.trns)


def _inflate(data: bytes, name: str) -> _Inflated:
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    return _Inflated(name, header, palette, trns, b"".join(idat))


def _inflate_file(path: str) -> _Inflated:
    with open(path, "rb") as f:
        return _inflate(f.read(), path)


def decode_png(data: bytes, name: str = "<bytes>") -> _Png:
    """Parse and unfilter a PNG file's bytes."""
    inf = _inflate(data, name)
    rows = _unfilter(inf.rows[None, :, 0], inf.rows[None, :, 1:], inf.bpp)[0]
    return inf.finish(rows)


def decode_png_files(paths) -> list:
    """Decode many files: a thread pool reads and inflates them (zlib
    releases the GIL), then files of one shape are unfiltered ``BATCH`` at a
    time in one wavefront, so that its per-diagonal steps are shared."""
    with ThreadPoolExecutor(max_workers=16) as pool:
        inflated = list(pool.map(_inflate_file, paths))
    groups = {}
    for i, inf in enumerate(inflated):
        groups.setdefault(inf.shape_key, []).append(i)
    out = [None] * len(inflated)
    for idx in groups.values():
        for s in range(0, len(idx), BATCH):
            part = [inflated[i] for i in idx[s:s + BATCH]]
            rows = np.stack([inf.rows for inf in part])
            done = _unfilter(rows[:, :, 0], rows[:, :, 1:], part[0].bpp)
            for k, i in enumerate(idx[s:s + BATCH]):
                out[i] = inflated[i].finish(done[k])
    return out


def _read(path: str) -> _Png:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _to_8bit(png: _Png) -> np.ndarray:
    """The samples in 8 bits as PIL holds them: 16-bit grey (PIL's I;16)
    saturates at 255, the other 16-bit types keep each sample's high byte."""
    s = png.samples
    if png.depth != 16:
        return s
    if png.color_type == 0:
        return np.minimum(s, 255).astype(np.uint8)
    return (s >> 8).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The file's samples as PIL's ``np.asarray(Image.open(path))`` gives
    them: (H, W) for grey (uint16 at depth 16) and palette indices,
    (H, W, C) uint8 otherwise; 16-bit colour keeps each sample's high byte,
    and 16-bit grey with alpha opens as RGBA."""
    png = _read(path)
    s = png.samples if png.color_type == 0 else _to_8bit(png)
    if png.depth == 16 and png.color_type == 4:
        s = s[..., [0, 0, 0, 1]]
    return s[..., 0] if s.shape[-1] == 1 else s


def read_png_rgba(path: str) -> np.ndarray:
    """(H, W, 4) uint8 as PIL's ``np.asarray(Image.open(path).convert(
    "RGBA"))``."""
    return _rgba(_read(path))


def read_pngs_rgba(paths) -> list:
    """:func:`read_png_rgba` of each path, decoded together
    (:func:`decode_png_files`)."""
    return [_rgba(png) for png in decode_png_files(paths)]


def _rgba(png: _Png) -> np.ndarray:
    s, ct = png.samples, png.color_type
    if ct == 3:
        k = png.palette.shape[0]
        lut = np.full((256, 4), 255, np.uint8)
        lut[:k, :3] = png.palette
        if png.trns is not None:
            alpha = np.frombuffer(png.trns, np.uint8)[:256]
            lut[:alpha.size, 3] = alpha
        return lut[s[..., 0]]
    # grey, grey + alpha, RGB, RGBA
    s8 = _to_8bit(png)
    out = np.empty((png.height, png.width, 4), np.uint8)
    out[..., :3] = s8[..., :1] if ct in (0, 4) else s8[..., :3]
    out[..., 3] = s8[..., -1] if ct in (4, 6) else 255
    if png.trns is not None and ct in (0, 2):
        # PIL compares the 8-bit samples with the key's low byte
        key = np.asarray(struct.unpack(f">{len(png.trns) // 2}H", png.trns)) & 0xFF
        out[np.all(s8 == key, axis=-1), 3] = 0
    return out


def _filter_rows(pix: np.ndarray, filters, bpp: int) -> np.ndarray:
    """(H, stride) uint8 rows → (H, 1 + stride) filtered rows, filter type
    ``filters[r % len(filters)]`` on row r."""
    H, stride = pix.shape
    x = pix.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    kind = np.asarray([filters[r % len(filters)] for r in range(H)], np.int64)
    pred = np.stack(preds)[kind, np.arange(H)]
    out = np.empty((H, stride + 1), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = ((x - pred) & 0xFF).astype(np.uint8)
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, filters=(0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of ``img``: (H, W) or (H, W, C) with C = 1 (grey), 2 (grey
    + alpha), 3 (RGB) or 4 (RGBA), uint8 (depth 8) or uint16 (depth 16).
    Row r is filtered with ``filters[r % len(filters)]`` (0 None, 1 Sub, 2
    Up, 3 Average, 4 Paeth); the default cycles all five."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png takes uint8 or uint16, not {img.dtype}")
    if C not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1 to 4 channels, not {C}")
    depth = 8 * img.dtype.itemsize
    bpp = C * img.dtype.itemsize
    rows = img.astype(">u2").view(np.uint8) if depth == 16 else img
    filtered = _filter_rows(rows.reshape(H, W * bpp), tuple(filters), bpp)
    return b"".join([
        SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[C], 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(filtered.tobytes())),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, img: np.ndarray, filters=(0, 1, 2, 3, 4)) -> None:
    """Write :func:`encode_png` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
