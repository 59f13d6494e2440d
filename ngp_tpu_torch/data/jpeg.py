"""JPEG reading without an imaging library: the C++ decoder of
``hostsrc/jpeg_decode.cpp`` (``ops/host_build.py`` compiles it with g++ at
first use), bit for bit what PIL gives through libjpeg-turbo's default
decode (islow IDCT, fancy upsampling, jdcolor.c's tables).

- :func:`read_jpeg` gives ``np.asarray(Image.open(path))``: (H, W) for a
  grey file, (H, W, 3) RGB otherwise.
- :func:`read_jpeg_rgba` gives PIL's ``convert("RGBA")``: grey replicated,
  alpha 255.
- :func:`read_jpegs_rgba` decodes many files in C++ threads, one a file.
- :func:`jpeg_size` reads the frame header only: PIL's ``size``.

Baseline, extended sequential and progressive Huffman files of 8-bit grey,
YCbCr or RGB samples are read; arithmetic coding, other precisions,
lossless and hierarchical files, CMYK and sampling other than 4:4:4, 4:2:2
and 4:2:0 raise ``NotImplementedError`` naming the mode, and a truncated
or corrupt file raises ``ValueError``.
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
    return host_build.jpeg_decode([_read(path)], rgba=False, names=[str(path)])[0]


def read_jpeg_rgba(path: str) -> np.ndarray:
    """(H, W, 4) uint8 RGBA, as PIL's ``convert("RGBA")``."""
    return read_jpegs_rgba([path], n_threads=1)[0]


def read_jpegs_rgba(paths: list, n_threads: int = 0) -> list:
    """(H, W, 4) uint8 RGBA for each file, decoded one a thread over
    ``n_threads`` C++ threads (0: one a hardware thread); the output does
    not depend on the thread count."""
    return host_build.jpeg_decode([_read(p) for p in paths], rgba=True, n_threads=n_threads,
                                  names=[str(p) for p in paths])
