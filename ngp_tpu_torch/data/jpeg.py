"""JPEG reading and writing without an imaging library: the C++ decoder of
``hostsrc/jpeg_decode.cpp`` (``ops/host_build.py`` compiles it with g++ at
first use), bit for bit what PIL gives through libjpeg-turbo's default
decode (islow IDCT, fancy upsampling, jdcolor.c's tables), and the C++
encoder of ``hostsrc/jpeg_encode.cpp``, byte for byte what PIL writes.

- :func:`read_jpeg` gives ``np.asarray(Image.open(path))``: (H, W) for a
  grey file, (H, W, 3) RGB otherwise; :func:`decode_jpeg` the same of a
  file's bytes.
- :func:`read_jpeg_rgba` gives PIL's ``convert("RGBA")``: grey replicated,
  alpha 255.
- :func:`read_jpegs_rgba` decodes many files in C++ threads, one a file.
- :func:`jpeg_size` reads the frame header only: PIL's ``size``.

Baseline, extended sequential and progressive Huffman files of 8-bit grey,
YCbCr or RGB samples are read; arithmetic coding, other precisions,
lossless and hierarchical files, CMYK and sampling other than 4:4:4, 4:2:2
and 4:2:0 raise ``NotImplementedError`` naming the mode, and a truncated
or corrupt file raises ``ValueError``.

- :func:`encode_jpeg` gives the bytes of PIL's
  ``Image.fromarray(rgb).save(f, format="JPEG", quality=q)`` for an
  (H, W, 3) uint8 RGB image: baseline, 4:2:0, JFIF, the standard tables
  scaled to ``quality``, no optimisation, no restart markers. Other
  shapes and dtypes raise ``ValueError`` naming the mode (PIL refuses
  RGBA as JPEG). :func:`write_jpeg` writes them to a file.
- :func:`encode_jpeg_reference` is the encoder's plain numpy twin, the
  same bytes; the tests hold the C++ encoder to it and both to PIL.
"""

from __future__ import annotations

import numpy as np

from ngp_tpu_torch.ops import host_build

JPEG_SUFFIXES = (".jpg", ".jpeg")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def jpeg_size(path: str) -> tuple:
    """(width, height) from the frame header, as PIL's ``Image.size``."""
    w, h, _, _ = host_build.jpeg_info(_read(path), str(path))
    return w, h


def read_jpeg(path: str) -> np.ndarray:
    """The decoded samples: (H, W) uint8 grey or (H, W, 3) uint8 RGB."""
    return decode_jpeg(_read(path), str(path))


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """:func:`read_jpeg` of a file's bytes."""
    return host_build.jpeg_decode([data], rgba=False, names=[name])[0]


def read_jpeg_rgba(path: str) -> np.ndarray:
    """(H, W, 4) uint8 RGBA, as PIL's ``convert("RGBA")``."""
    return read_jpegs_rgba([path], n_threads=1)[0]


def read_jpegs_rgba(paths: list, n_threads: int = 0) -> list:
    """(H, W, 4) uint8 RGBA for each file, decoded one a thread over
    ``n_threads`` C++ threads (0: one a hardware thread); the output does
    not depend on the thread count."""
    return host_build.jpeg_decode([_read(p) for p in paths], rgba=True, n_threads=n_threads,
                                  names=[str(p) for p in paths])


def _check_rgb(rgb, quality: int) -> np.ndarray:
    a = np.asarray(rgb)
    if a.dtype != np.uint8:
        raise ValueError(f"cannot write a {a.dtype} image as JPEG: the encoder takes "
                         "(H, W, 3) uint8 RGB")
    if a.ndim != 3 or a.shape[2] != 3:
        mode = {2: "L", 3: {1: "L", 2: "LA", 4: "RGBA"}.get(a.shape[-1])}.get(a.ndim)
        raise ValueError(f"cannot write mode {mode or a.shape} as JPEG: the encoder takes "
                         "(H, W, 3) uint8 RGB")
    if not (1 <= a.shape[0] <= 65535 and 1 <= a.shape[1] <= 65535):
        raise ValueError(f"cannot write a {a.shape[1]}x{a.shape[0]} image as JPEG")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"JPEG quality {quality} outside 1-100")
    return a


def encode_jpeg(rgb, quality: int = 75) -> bytes:
    """The JPEG file of the (H, W, 3) uint8 RGB image ``rgb``, as PIL saves
    it at ``quality`` (its default 75)."""
    return host_build.jpeg_encode(_check_rgb(rgb, quality), int(quality))


def write_jpeg(path: str, rgb, quality: int = 75) -> None:
    data = encode_jpeg(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)


# -- the encoder's numpy twin

# zigzag index -> natural (row-major) index
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
    15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
    62, 63])
# jcparam.c's standard quantisation tables (natural order)
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24,
    40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95,
    98, 112, 100, 103, 99])
_CHROMA_QUANT = np.full(64, 99)
_CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# jstdhuff.c's tables: code counts of lengths 1..16, then the symbols
_DC_VALS = bytes(range(12))
_HUFFMAN = {
    "dc0": (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), _DC_VALS),
    "dc1": (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), _DC_VALS),
    "ac0": (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282"
        "090a161718191a25262728292a3435363738393a434445464748494a535455565758595a63"
        "6465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6"
        "a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
        "e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    "ac1": (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a"
        "162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a"
        "636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4"
        "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
        "e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def _scaled_quant(basic: np.ndarray, quality: int) -> np.ndarray:
    """jpeg_quality_scaling, then jpeg_add_quant_table with force_baseline."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((basic * scale + 50) // 100, 1, 255)


def _reciprocals(quant: np.ndarray):
    """compute_reciprocal of each divisor 8·quant with 16-bit DCT elements:
    (recip, corr, shift) with q = (|x| + corr)·recip >> shift."""
    recip, corr, shift = [], [], []
    for d in (quant.astype(np.int64) << 3).tolist():
        r = 16 + d.bit_length() - 1
        fq, fr, c = (1 << r) // d, (1 << r) % d, d // 2
        if fr == 0:
            fq, r = fq >> 1, r - 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq), corr.append(c), shift.append(r)
    return np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64)


def _huffman_codes(bits: bytes, vals: bytes):
    """(code, length) a symbol (jpeg_make_c_derived_tbl); length 0 where none."""
    code, size = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            code[vals[k]], size[vals[k]] = c, length
            c, k = c + 1, k + 1
        c <<= 1
    return code, size


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c's islow forward DCT of (N, 8, 8) int64 samples − 128,
    rows then columns; 8× the orthonormal DCT, as libjpeg scales it."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, last):
        odd = 15 if last else 11  # CONST_BITS ± PASS1_BITS
        p = [d[..., i] for i in range(8)]
        t0, t7 = p[0] + p[7], p[0] - p[7]
        t1, t6 = p[1] + p[6], p[1] - p[6]
        t2, t5 = p[2] + p[5], p[2] - p[5]
        t3, t4 = p[3] + p[4], p[3] - p[4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = [None] * 8
        if last:
            out[0], out[4] = descale(t10 + t11, 2), descale(t10 - t11, 2)
        else:
            out[0], out[4] = (t10 + t11) * 4, (t10 - t11) * 4
        z1 = (t12 + t13) * 4433
        out[2] = descale(z1 + t13 * 6270, odd)
        out[6] = descale(z1 - t12 * 15137, odd)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(t4 + z1 + z3, odd)
        out[5] = descale(t5 + z2 + z4, odd)
        out[3] = descale(t6 + z2 + z3, odd)
        out[1] = descale(t7 + z1 + z4, odd)
        return np.stack(out, -1)

    rows = one_pass(blocks, False)
    return one_pass(rows.swapaxes(-1, -2), True).swapaxes(-1, -2)


def _quantized_blocks(plane: np.ndarray, n_by: int, n_bx: int, quant: np.ndarray) -> np.ndarray:
    """(n_by, n_bx, 64) quantized coefficients (natural order) of the
    plane's first n_by × n_bx blocks."""
    p = plane[:n_by * 8, :n_bx * 8].astype(np.int64) - 128
    blocks = p.reshape(n_by, 8, n_bx, 8).swapaxes(1, 2).reshape(-1, 8, 8)
    coef = _fdct_islow(blocks).reshape(-1, 64)
    recip, corr, shift = _reciprocals(quant)
    q = ((np.abs(coef) + corr) * recip) >> shift
    return (np.sign(coef) * q).reshape(n_by, n_bx, 64)


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The bit string of ``values`` (MSB first, ``lengths`` bits each),
    1-padded to a byte, with each 0xFF byte followed by 0x00."""
    total = int(lengths.sum())
    item = np.repeat(np.arange(len(values)), lengths)
    start = np.cumsum(lengths) - lengths
    pos = np.arange(total) - start[item]
    bits = (values[item] >> (lengths[item] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones((-total) % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def encode_jpeg_reference(rgb, quality: int = 75) -> bytes:
    """:func:`encode_jpeg` in plain numpy (vectorised over blocks and
    symbols): the same bytes, for the tests."""
    a = _check_rgb(rgb, quality).astype(np.int64)
    quality = int(quality)
    H, W = a.shape[:2]
    mcu_cols, mcu_rows = (W + 15) // 16, (H + 15) // 16
    # full-resolution planes over whole MCUs, the last row and column replicated
    ys = np.minimum(np.arange(mcu_rows * 16), H - 1)
    xs = np.minimum(np.arange(mcu_cols * 16), W - 1)
    full = a[ys][:, xs]
    r, g, b = full[..., 0], full[..., 1], full[..., 2]
    half, offset = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    chroma = [(-11059 * r - 21709 * g + 32768 * b + offset + half - 1) >> 16,
              (32768 * r - 27439 * g - 5329 * b + offset + half - 1) >> 16]
    # h2v2: rows 2i and 2i + 1 (past the image, its last row), rounding bias
    # 1, 2 along each row; rows of the average past ceil(H / 2) repeat its last
    sy = np.minimum(np.arange(mcu_rows * 8), (H + 1) // 2 - 1)
    bias = np.tile([1, 2], mcu_cols * 4)
    sub = []
    for c in chroma:
        r0, r1 = c[2 * sy], c[np.minimum(2 * sy + 1, H - 1)]
        sub.append((r0[:, 0::2] + r0[:, 1::2] + r1[:, 0::2] + r1[:, 1::2] + bias) >> 2)
    lq, cq = _scaled_quant(_LUMA_QUANT, quality), _scaled_quant(_CHROMA_QUANT, quality)
    ybh, ybw = (H + 7) // 8, (W + 7) // 8
    yq = _quantized_blocks(y, ybh, ybw, lq)
    cbq = _quantized_blocks(sub[0], mcu_rows, mcu_cols, cq)
    crq = _quantized_blocks(sub[1], mcu_rows, mcu_cols, cq)
    # Y over whole MCUs: a dummy block (AC 0) right of the last block column
    # has the DC of its left neighbour, one below the last block row that of
    # the last block of the row above in its MCU (its left neighbour's DC
    # where that one is a dummy too)
    yb = np.zeros((mcu_rows * 2, mcu_cols * 2, 64), np.int64)
    yb[:ybh, :ybw] = yq
    if ybw % 2:
        yb[:ybh, ybw, 0] = yq[:, -1, 0]
    if ybh % 2:
        yb[ybh, :, 0] = np.repeat(yb[ybh - 1, 1::2, 0], 2)
    # MCU order: Y00, Y01, Y10, Y11, Cb, Cr
    ym = yb.reshape(mcu_rows, 2, mcu_cols, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([ym.reshape(mcu_rows, mcu_cols, 4, 64), cbq[:, :, None],
                           crq[:, :, None]], 2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], mcu_rows * mcu_cols)
    table = np.minimum(comp, 1)
    # DC differences within each component's sequence of blocks
    dc = mcus[:, 0]
    diff = np.zeros_like(dc)
    for ci in range(3):
        idx = np.flatnonzero(comp == ci)
        diff[idx] = np.diff(dc[idx], prepend=0)
    codes = {k: _huffman_codes(*v) for k, v in _HUFFMAN.items()}
    dc_code = np.stack([codes["dc0"][0], codes["dc1"][0]])
    dc_size = np.stack([codes["dc0"][1], codes["dc1"][1]])
    ac_code = np.stack([codes["ac0"][0], codes["ac1"][0]])
    ac_size = np.stack([codes["ac0"][1], codes["ac1"][1]])

    def category(v):  # bits of |v|: frexp's exponent, 0 for 0
        return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)

    def extra(v, n):  # v, or v − 1 for v < 0, in n bits
        return np.where(v < 0, v - 1, v) & ((1 << n) - 1)

    # items (value, length, block, slot): DC at slot 0; a nonzero AC at
    # zigzag k at slot 2k, the ZRLs before it at 2k − 1; EOB at slot 128
    nb = category(diff)
    t = table
    items = [(dc_code[t, nb] << nb | extra(diff, nb), dc_size[t, nb] + nb,
              np.arange(len(dc)), np.zeros_like(dc))]
    zz = mcus[:, _NATURAL[1:]]  # (n, 63), zigzag 1..63
    blk, kk = np.nonzero(zz)
    v = zz[blk, kk]
    k = kk + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    n_zrl = run // 16
    zt = t[np.repeat(blk, n_zrl)]
    items.append((ac_code[zt, 0xF0], ac_size[zt, 0xF0], np.repeat(blk, n_zrl),
                  np.repeat(2 * k - 1, n_zrl)))
    nb = category(v)
    sym = (run % 16) * 16 + nb
    items.append((ac_code[t[blk], sym] << nb | extra(v, nb), ac_size[t[blk], sym] + nb,
                  blk, 2 * k))
    last = np.full(len(dc), 0)
    last[blk] = k  # the last nonzero's index, blk being sorted
    eob = np.flatnonzero(last < 63)
    items.append((ac_code[t[eob], 0], ac_size[t[eob], 0], eob, np.full(len(eob), 128)))
    values, lengths, blocks, slots = (np.concatenate(c) for c in zip(*items))
    order = np.lexsort((slots, blocks))
    scan = _pack_bits(values[order], lengths[order])

    def marker(code: int, body: bytes) -> bytes:
        return bytes([0xFF, code]) + (len(body) + 2).to_bytes(2, "big") + body

    head = b"\xff\xd8" + marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, q in enumerate((lq, cq)):
        head += marker(0xDB, bytes([i]) + bytes(q[_NATURAL].astype(np.uint8)))
    head += marker(0xC0, bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
                   + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for name, tc in (("dc0", 0x00), ("ac0", 0x10), ("dc1", 0x01), ("ac1", 0x11)):
        head += marker(0xC4, bytes([tc]) + _HUFFMAN[name][0] + _HUFFMAN[name][1])
    head += marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + scan + b"\xff\xd9"
