"""Minimal OpenEXR scanline codec (read + write), pure numpy: the port's
copy of ``ngp_tpu/data/exr.py``.

No EXR-capable library is needed: this reads and writes what HDR capture
frames, environment maps and EXR screenshots use: single-part scanline
images, HALF/FLOAT/UINT channels, NONE/ZIPS/ZIP compression, increasing
line order.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}  # UINT, HALF, FLOAT
_PIXEL_TYPES = {np.dtype(np.float16): 1, np.dtype(np.float32): 2, np.dtype(np.uint32): 0}


def _read_nullterm(f) -> bytes:
    out = b""
    while (c := f.read(1)) not in (b"\x00", b""):
        out += c
    return out


def _unpredict_and_interleave(data: bytes) -> np.ndarray:
    """Invert EXR's ZIP post-filter: delta-decode, then interleave halves."""
    # Delta decode: d[0] = raw[0]; d[i] = d[i-1] + raw[i] - 128 (mod 256).
    deltas = np.frombuffer(data, np.uint8).astype(np.int64)
    deltas = deltas - 128
    deltas[0] += 128
    arr = np.cumsum(deltas).astype(np.uint8)
    half = (len(arr) + 1) // 2
    out = np.empty_like(arr)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out


def _deinterleave_and_predict(data: np.ndarray) -> bytes:
    """EXR ZIP pre-filter: split even/odd bytes, then delta-encode."""
    half = (len(data) + 1) // 2
    tmp = np.empty_like(data)
    tmp[:half] = data[0::2]
    tmp[half:] = data[1::2]
    t = tmp.astype(np.int64)
    enc = t.copy()
    enc[1:] = t[1:] - t[:-1] + 128
    return enc.astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read an EXR into (H, W, C) float32, channels ordered RGBA (present
    channels only, alphabet-ordered files reordered)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError("tiled EXR not supported")

        channels: list[tuple[str, int]] = []
        compression = 0
        data_window = (0, 0, 0, 0)
        while True:
            name = _read_nullterm(f)
            if name == b"":
                break
            atype = _read_nullterm(f)
            (size,) = struct.unpack("<i", f.read(4))
            data = f.read(size)
            if name == b"channels":
                off = 0
                while data[off] != 0:
                    end = data.index(b"\x00", off)
                    cname = data[off:end].decode()
                    # layout: int pixel_type, char pLinear + 3 reserved,
                    # int xSampling, int ySampling  (16 bytes)
                    ptype, _xs, _ys = struct.unpack_from("<i4xii", data, end + 1)
                    channels.append((cname, ptype))
                    off = end + 1 + 16
            elif name == b"compression":
                compression = data[0]
            elif name == b"dataWindow":
                data_window = struct.unpack("<iiii", data)

        xmin, ymin, xmax, ymax = data_window
        W, H = xmax - xmin + 1, ymax - ymin + 1
        if compression == 0:
            lines_per_block = 1
        elif compression == 2:  # ZIPS
            lines_per_block = 1
        elif compression == 3:  # ZIP
            lines_per_block = 16
        else:
            raise ValueError(f"unsupported EXR compression {compression}")

        n_blocks = (H + lines_per_block - 1) // lines_per_block
        f.read(8 * n_blocks)  # offset table (we read sequentially)

        chans = {name: np.empty((H, W), _PIXEL_DTYPES[pt]) for name, pt in channels}
        dtypes = {name: _PIXEL_DTYPES[pt] for name, pt in channels}
        for _ in range(n_blocks):
            y, nbytes = struct.unpack("<ii", f.read(8))
            blob = f.read(nbytes)
            n_lines = min(lines_per_block, ymax - y + 1)
            raw_size = sum(
                W * np.dtype(dtypes[c]).itemsize for c, _ in channels
            ) * n_lines
            if compression in (2, 3) and nbytes < raw_size:
                blob = _unpredict_and_interleave(zlib.decompress(blob)).tobytes()
            off = 0
            for line in range(n_lines):
                for cname, _pt in channels:
                    dt = np.dtype(dtypes[cname])
                    cnt = W * dt.itemsize
                    chans[cname][y - ymin + line] = np.frombuffer(
                        blob[off : off + cnt], dt
                    )
                    off += cnt

    order = [c for c in ("R", "G", "B", "A") if c in chans]
    if not order:  # luminance or arbitrary channels: keep file order
        order = [c for c, _ in channels]
    img = np.stack([chans[c].astype(np.float32) for c in order], axis=-1)
    return img


def write_exr(path: str, img: np.ndarray) -> None:
    """Write (H, W, C<=4) float32/float16 as a half EXR with ZIP compression."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    names = ["R", "G", "B", "A"][:C]
    data = img.astype(np.float16)

    with open(path, "wb") as f:
        f.write(struct.pack("<II", _MAGIC, 2))

        def attr(name: bytes, atype: bytes, payload: bytes):
            f.write(name + b"\x00" + atype + b"\x00")
            f.write(struct.pack("<i", len(payload)))
            f.write(payload)

        chlist = b""
        for n in sorted(names):  # EXR requires alphabetical channel order
            chlist += n.encode() + b"\x00" + struct.pack("<i4xii", 1, 1, 1)
        chlist += b"\x00"
        attr(b"channels", b"chlist", chlist)
        attr(b"compression", b"compression", bytes([3]))
        box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
        attr(b"dataWindow", b"box2i", box)
        attr(b"displayWindow", b"box2i", box)
        attr(b"lineOrder", b"lineOrder", bytes([0]))
        attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        f.write(b"\x00")

        lines_per_block = 16
        n_blocks = (H + lines_per_block - 1) // lines_per_block
        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * n_blocks)

        sorted_idx = [names.index(n) for n in sorted(names)]
        offsets = []
        for b in range(n_blocks):
            y0 = b * lines_per_block
            n_lines = min(lines_per_block, H - y0)
            rows = []
            for line in range(n_lines):
                for ci in sorted_idx:
                    rows.append(data[y0 + line, :, ci].tobytes())
            raw = b"".join(rows)
            filtered = _deinterleave_and_predict(np.frombuffer(raw, np.uint8))
            comp = zlib.compress(filtered)
            payload = comp if len(comp) < len(raw) else raw
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(payload)))
            f.write(payload)

        f.seek(offset_table_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))
