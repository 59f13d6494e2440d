"""Minimal NanoVDB (ABI version 32.3) FloatGrid codec, the port's own copy
of ``ngp_tpu/data/nanovdb_codec.py`` (numpy only; each package reads the
other's files, and both write the same bytes for the same array).

Reads and writes uncompressed single-grid ``.nvdb`` files containing a
``NanoGrid<float>`` — enough to interchange density volumes with the
reference's volume mode, which parses the same file framing manually
(``src/testbed_volume.cu:546-571``) and then walks the standard tree.

Struct layouts transcribed from the vendored header
(``dependencies/nanovdb/nanovdb/NanoVDB.h``, 32-byte alignment,
``USE_SINGLE_ROOT_KEY``):

* File header (16B): magic "NanoVDB0", version, gridCount, codec.
* File metadata (176B) + grid name.
* GridData (672B): magic, checksum, version, flags, grid index/count/size,
  name[256], Map (264B), world bbox (2×3 doubles), voxel size, class, type.
* TreeData (64B): node offsets (leaf, lower, upper, root), node counts,
  tile counts, voxel count.
* RootData: index bbox, tile table (key 8B / child offset / state / value),
  then upper InternalData (32³: bbox+masks+tile table), lower InternalData
  (16³), LeafData (8³: bbox, value mask, min/max/avg/dev, 512 floats).

The writer emits a dense-leaf tree (every 8³ block covering the array) with
a single upper/lower chain per occupied 128³/4096³ region; the reader walks
arbitrary well-formed trees. The JAX package's tests check its writer
against the real NanoVDB.h accessors (``tools/nvdb_check.cpp``);
``tests/test_torch_volume.py`` holds this copy to that writer byte for
byte.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0"
ALIGN = 32

# enum GridType { Unknown=0, Float=1, ... } / GridClass { Unknown=0, LevelSet=1, FogVolume=2, ... }
GRID_TYPE_FLOAT = 1
GRID_CLASS_FOG = 2

_VERSION = (32 << 21) | (3 << 10) | 0  # major 32, minor 3, patch 0


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


def _mask_words(log2dim: int) -> int:
    return (1 << (3 * log2dim)) // 64


def _sizeof_leaf() -> int:
    # CoordT(12) + bboxdif(3) + flags(1) + mask(64) + min/max/avg/dev(16) +
    # align(32) + values(512*4)
    base = 12 + 3 + 1 + 64 + 16
    return _align(_align(base) + 512 * 4)


def _sizeof_internal(log2dim: int) -> int:
    n = 1 << (3 * log2dim)
    base = 24 + 8 + n // 8 + n // 8  # bbox + flags + value mask + child mask
    base += 16  # min/max/avg/dev
    return _align(_align(base) + n * 8)  # 8B tiles (union value/child)


SZ_LEAF = _sizeof_leaf()
SZ_LOWER = _sizeof_internal(4)
SZ_UPPER = _sizeof_internal(5)
SZ_GRIDDATA = 672
SZ_TREEDATA = 64
SZ_ROOT_BASE = _align(24 + 4 + 4 * 5)  # bbox + tableSize + bg/min/max/avg/dev
SZ_ROOT_TILE = _align(8 + 8 + 4 + 4)  # key + child + state + value


def root_key(i: int, j: int, k: int) -> int:
    """USE_SINGLE_ROOT_KEY coordinate hashing (upper nodes span 4096)."""
    return ((np.uint64(np.uint32(i) >> np.uint32(12)) << np.uint64(42))
            | (np.uint64(np.uint32(j) >> np.uint32(12)) << np.uint64(21))
            | np.uint64(np.uint32(k) >> np.uint32(12)))


def write_nanovdb(path: str, density: np.ndarray, grid_name: str = "density") -> None:
    """Write a dense (X, Y, Z) float32 array (index origin 0) as an
    uncompressed single-grid .nvdb FloatGrid. Requires shape ≤ 4096³
    (single root tile / upper node)."""
    density = np.ascontiguousarray(density, np.float32)
    X, Y, Z = density.shape
    assert max(X, Y, Z) <= 4096, "writer supports a single upper node"

    # --- enumerate nodes (dense coverage of the array extent)
    nlx, nly, nlz = (X + 7) // 8, (Y + 7) // 8, (Z + 7) // 8
    llx, lly, llz = (X + 127) // 128, (Y + 127) // 128, (Z + 127) // 128

    n_leaf = nlx * nly * nlz
    n_lower = llx * lly * llz
    n_upper = 1

    off_tree = 0
    off_root = SZ_TREEDATA
    off_upper = off_root + SZ_ROOT_BASE + SZ_ROOT_TILE
    off_lower0 = off_upper + SZ_UPPER
    off_leaf0 = off_lower0 + n_lower * SZ_LOWER
    tree_size = off_leaf0 + n_leaf * SZ_LEAF
    grid_size = SZ_GRIDDATA + tree_size

    buf = bytearray(grid_size)

    mn = float(density.min()) if density.size else 0.0
    mx = float(density.max()) if density.size else 0.0

    # --- GridData
    name_b = grid_name.encode()[:255]
    o = 0
    struct.pack_into("<QQIIIIQ", buf, o, MAGIC, 0, _VERSION, 0, 0, 1, grid_size)
    o += 8 + 8 + 4 + 4 + 4 + 4 + 8
    buf[o : o + len(name_b)] = name_b
    o += 256
    # Map: identity (floats then doubles)
    eye = [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]
    struct.pack_into("<9f9f3ff", buf, o, *eye, *eye, 0, 0, 0, 0.0)
    o += 22 * 4
    struct.pack_into("<9d9d3dd", buf, o, *eye, *eye, 0, 0, 0, 0.0)
    o += 22 * 8
    struct.pack_into("<6d", buf, o, 0.0, 0.0, 0.0, float(X), float(Y), float(Z))
    o += 48
    struct.pack_into("<3d", buf, o, 1.0, 1.0, 1.0)  # voxel size
    o += 24
    struct.pack_into("<II", buf, o, GRID_CLASS_FOG, GRID_TYPE_FLOAT)
    o += 8
    struct.pack_into("<qI", buf, o, 0, 0)  # blind metadata
    assert o + 12 <= SZ_GRIDDATA

    base = SZ_GRIDDATA  # tree base offset within buf

    # --- TreeData: offsets are relative to the tree
    struct.pack_into(
        "<4Q3I3IQ",
        buf,
        base + off_tree,
        off_leaf0, off_lower0, off_upper, off_root,
        n_leaf, n_lower, n_upper,
        0, 0, 0,
        int((density > 0).sum()),
    )

    # --- RootData + one child tile
    ro = base + off_root
    struct.pack_into("<6i", buf, ro, 0, 0, 0, X - 1, Y - 1, Z - 1)
    struct.pack_into("<I", buf, ro + 24, 1)  # mTableSize
    struct.pack_into("<5f", buf, ro + 28, 0.0, mn, mx, 0.0, 0.0)
    to = ro + SZ_ROOT_BASE
    struct.pack_into("<Qq I f", buf, to, int(root_key(0, 0, 0)), off_upper - off_root, 0, 0.0)

    # --- helpers for masks/tiles
    def set_mask_bit(offset, n):
        buf[offset + n // 8] |= 1 << (n % 8)

    # --- Upper internal node (32³ children of 128³ each)
    uo = base + off_upper
    struct.pack_into("<6i", buf, uo, 0, 0, 0, X - 1, Y - 1, Z - 1)
    struct.pack_into("<Q", buf, uo + 24, 0)  # flags
    value_mask_off = uo + 32
    child_mask_off = value_mask_off + 4096
    stats_off = child_mask_off + 4096
    struct.pack_into("<4f", buf, stats_off, mn, mx, 0.0, 0.0)
    table_off = _align(stats_off + 16 - uo) + uo
    for li in range(llx):
        for lj in range(lly):
            for lk in range(llz):
                # n = i<<2*5 | j<<5 | k over the 32³ table (bit-interlerp per header:
                # CoordToOffset uses (ijk&mask) >> child_total packed x-major)
                n = (li << 10) | (lj << 5) | lk
                set_mask_bit(child_mask_off, n)
                lower_idx = (li * lly + lj) * llz + lk
                child_off = (off_lower0 + lower_idx * SZ_LOWER) - off_upper
                struct.pack_into("<q", buf, table_off + n * 8, child_off)

    # --- Lower internal nodes (16³ children of 8³ each)
    for li in range(llx):
        for lj in range(lly):
            for lk in range(llz):
                lower_idx = (li * lly + lj) * llz + lk
                lo = base + off_lower0 + lower_idx * SZ_LOWER
                ox, oy, oz = li * 128, lj * 128, lk * 128
                struct.pack_into(
                    "<6i", buf, lo, ox, oy, oz,
                    min(ox + 127, X - 1), min(oy + 127, Y - 1), min(oz + 127, Z - 1),
                )
                struct.pack_into("<Q", buf, lo + 24, 0)
                vmask = lo + 32
                cmask = vmask + 512
                stats = cmask + 512
                struct.pack_into("<4f", buf, stats, mn, mx, 0.0, 0.0)
                ltable = _align(stats + 16 - lo) + lo
                for bi in range(16):
                    for bj in range(16):
                        for bk in range(16):
                            gx, gy, gz = ox + bi * 8, oy + bj * 8, oz + bk * 8
                            if gx >= X or gy >= Y or gz >= Z:
                                continue
                            n = (bi << 8) | (bj << 4) | bk
                            set_mask_bit(cmask, n)
                            leaf_idx = ((gx // 8) * nly + gy // 8) * nlz + gz // 8
                            child_off = (
                                off_leaf0 + leaf_idx * SZ_LEAF
                            ) - (off_lower0 + lower_idx * SZ_LOWER)
                            struct.pack_into("<q", buf, ltable + n * 8, child_off)

    # --- Leaf nodes: vectorized value fill
    pad = np.zeros((nlx * 8, nly * 8, nlz * 8), np.float32)
    pad[:X, :Y, :Z] = density
    blocks = pad.reshape(nlx, 8, nly, 8, nlz, 8).transpose(0, 2, 4, 1, 3, 5)
    blocks = np.ascontiguousarray(blocks.reshape(n_leaf, 512))
    leaf_hdr = np.zeros((n_leaf, SZ_LEAF // 4), np.uint32)
    coords = np.stack(
        np.meshgrid(
            np.arange(nlx) * 8, np.arange(nly) * 8, np.arange(nlz) * 8, indexing="ij"
        ),
        axis=-1,
    ).reshape(n_leaf, 3)
    leaf_hdr[:, 0:3] = coords.astype(np.uint32)
    # mBBoxDif = 7,7,7 ; mFlags = 0
    leaf_hdr[:, 3] = 7 | (7 << 8) | (7 << 16)
    # value mask: all on (we store every voxel of covered blocks)
    leaf_hdr[:, 4:20] = 0xFFFFFFFF
    stats = np.zeros((n_leaf, 4), np.float32)
    stats[:, 0] = blocks.min(axis=1)
    stats[:, 1] = blocks.max(axis=1)
    leaf_hdr[:, 20:24] = stats.view(np.uint32)
    values_word0 = _align(96) // 4  # header is 96B, values start 32B-aligned
    leaf_hdr[:, values_word0 : values_word0 + 512] = blocks.view(np.uint32)
    buf[base + off_leaf0 : base + off_leaf0 + n_leaf * SZ_LEAF] = leaf_hdr.tobytes()

    # --- file framing
    with open(path, "wb") as f:
        f.write(struct.pack("<QIHH", MAGIC, _VERSION, 1, 0))
        name_field = grid_name.encode() + b"\0"
        f.write(
            struct.pack(
                "<4Q2I",
                grid_size, grid_size, 0, int((density > 0).sum()),
                GRID_TYPE_FLOAT, GRID_CLASS_FOG,
            )
        )
        f.write(struct.pack("<6d", 0, 0, 0, float(X), float(Y), float(Z)))
        f.write(struct.pack("<6i", 0, 0, 0, X - 1, Y - 1, Z - 1))
        f.write(struct.pack("<3d", 1.0, 1.0, 1.0))
        f.write(struct.pack("<I", len(name_field)))
        f.write(struct.pack("<4I", n_leaf, n_lower, n_upper, 1))
        f.write(struct.pack("<3I", 0, 0, 0))
        f.write(struct.pack("<HHI", 0, 0, _VERSION))
        f.write(name_field)
        f.write(bytes(buf))


def read_nanovdb_dense(path: str) -> np.ndarray:
    """Read an uncompressed single-FloatGrid .nvdb into a dense array over
    its index bounding box (values outside active leaves = background)."""
    with open(path, "rb") as f:
        magic, version, grid_count, codec = struct.unpack("<QIHH", f.read(16))
        if magic != MAGIC:
            raise ValueError("not a nanovdb file")
        if codec != 0:
            raise ValueError("compressed nvdb not supported")
        if grid_count < 1:
            raise ValueError("no grids")
        meta = f.read(176)
        (grid_size, _file_size, _namekey, _voxcount) = struct.unpack_from("<4Q", meta, 0)
        grid_type, _grid_class = struct.unpack_from("<2I", meta, 32)
        ibb = struct.unpack_from("<6i", meta, 88)
        name_size = struct.unpack_from("<I", meta, 136)[0]
        f.read(name_size)
        grid = f.read(grid_size)
    if grid_type != GRID_TYPE_FLOAT:
        raise ValueError(f"unsupported grid type {grid_type}")

    # GridData → tree
    tree_base = SZ_GRIDDATA
    (off_leaf, off_lower, off_upper, off_root) = struct.unpack_from(
        "<4Q", grid, tree_base
    )
    ro = tree_base + off_root
    bbox = struct.unpack_from("<6i", grid, ro)
    table_size = struct.unpack_from("<I", grid, ro + 24)[0]
    background = struct.unpack_from("<f", grid, ro + 28)[0]

    x0, y0, z0, x1, y1, z1 = bbox
    out = np.full((x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1), background, np.float32)

    def leaf_values(abs_off):
        vals_off = abs_off + _align(96)
        return np.frombuffer(grid, np.float32, 512, vals_off).reshape(8, 8, 8)

    def read_lower(abs_off, ox, oy, oz):
        cmask = np.frombuffer(grid, np.uint8, 512, abs_off + 32 + 512)
        vmask = np.frombuffer(grid, np.uint8, 512, abs_off + 32)
        table = abs_off + _align(abs_off + 32 + 512 + 512 + 16 - abs_off)
        for n in range(4096):
            bi, bj, bk = (n >> 8) & 15, (n >> 4) & 15, n & 15
            gx, gy, gz = ox + bi * 8, oy + bj * 8, oz + bk * 8
            if cmask[n // 8] & (1 << (n % 8)):
                (child,) = struct.unpack_from("<q", grid, table + n * 8)
                v = leaf_values(abs_off + child)
                _paste(out, v, gx - x0, gy - y0, gz - z0)
            elif vmask[n // 8] & (1 << (n % 8)):
                (val,) = struct.unpack_from("<f", grid, table + n * 8)
                _paste(out, np.full((8, 8, 8), val, np.float32), gx - x0, gy - y0, gz - z0)

    def read_upper(abs_off, ox, oy, oz):
        cmask = np.frombuffer(grid, np.uint8, 4096, abs_off + 32 + 4096)
        vmask = np.frombuffer(grid, np.uint8, 4096, abs_off + 32)
        table = abs_off + _align(abs_off + 32 + 4096 + 4096 + 16 - abs_off)
        for n in range(32768):
            i, j, k = (n >> 10) & 31, (n >> 5) & 31, n & 31
            gx, gy, gz = ox + i * 128, oy + j * 128, oz + k * 128
            if cmask[n // 8] & (1 << (n % 8)):
                (child,) = struct.unpack_from("<q", grid, table + n * 8)
                read_lower(abs_off + child, gx, gy, gz)
            elif vmask[n // 8] & (1 << (n % 8)):
                (val,) = struct.unpack_from("<f", grid, table + n * 8)
                _paste(out, np.full((128, 128, 128), val, np.float32), gx - x0, gy - y0, gz - z0)

    tiles = ro + SZ_ROOT_BASE
    for t in range(table_size):
        to = tiles + t * SZ_ROOT_TILE
        key, child, state, value = struct.unpack_from("<QqIf", grid, to)
        kx = int((key >> 42) & 0x1FFFFF) << 12
        ky = int((key >> 21) & 0x1FFFFF) << 12
        kz = int(key & 0x1FFFFF) << 12
        # sign-extend 21-bit coords (negative coords wrap in uint space)
        if child:
            read_upper(ro + child, kx, ky, kz)
        elif state:
            _paste(
                out,
                np.full((4096, 4096, 4096), value, np.float32),
                kx - x0, ky - y0, kz - z0,
            )
    return out


def _paste(out, block, x, y, z):
    X, Y, Z = out.shape
    bx, by, bz = block.shape
    sx0, sy0, sz0 = max(x, 0), max(y, 0), max(z, 0)
    sx1, sy1, sz1 = min(x + bx, X), min(y + by, Y), min(z + bz, Z)
    if sx0 >= sx1 or sy0 >= sy1 or sz0 >= sz1:
        return
    out[sx0:sx1, sy0:sy1, sz0:sz1] = block[
        sx0 - x : sx1 - x, sy0 - y : sy1 - y, sz0 - z : sz1 - z
    ]
