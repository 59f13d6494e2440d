"""Convert an image to the raw fp16 ``.bin`` gigapixel format, or to EXR or
PNG (reference ``scripts/convert_image.py``). The ``.bin`` layout is the
reference's (int32 h, int32 w, then half RGBA rows,
``testbed_image.cu:420-438``). The input is read by
``data/image_loader.load_image`` (PNG, JPEG, EXR, ``.bin``), in linear
colour; a PNG is written as 8-bit sRGB RGB.

    python -m ngp_tpu_torch.scripts.convert_image --input photo.jpg \\
        --output photo.bin
"""

import argparse
import os

import numpy as np
import torch

from ngp_tpu_torch.data.exr import write_exr
from ngp_tpu_torch.data.image_loader import load_image, save_binary_image
from ngp_tpu_torch.data.png import write_png
from ngp_tpu_torch.ops.tonemap import linear_to_srgb

OUTPUT_SUFFIXES = (".bin", ".exr", ".png")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="", help="defaults to <input>.bin")
    args = ap.parse_args(argv)

    out = args.output or os.path.splitext(args.input)[0] + ".bin"
    if not out.endswith(OUTPUT_SUFFIXES):
        raise ValueError(f"cannot write {out!r}: the port writes .bin, .exr and .png images "
                         "(JPEG encoding is ROADMAP A11)")
    img = load_image(args.input)  # (H, W, 4) float32 linear
    print(f"{img.shape[1]}x{img.shape[0]} pixels, {img.shape[2]} channels")
    if out.endswith(".bin"):
        save_binary_image(out, img.astype(np.float16))
    elif out.endswith(".exr"):
        write_exr(out, img)
    else:
        srgb = linear_to_srgb(torch.from_numpy(np.ascontiguousarray(img[..., :3]))).numpy()
        write_png(out, np.clip(srgb * 255, 0, 255).astype(np.uint8))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
