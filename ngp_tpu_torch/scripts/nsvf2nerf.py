"""Convert an NSVF-format scene (intrinsics.txt/bbox.txt/pose/rgb) to
transforms_{train,val,test}.json (reference ``scripts/nsvf2nerf.py``).

    python -m ngp_tpu_torch.scripts.nsvf2nerf --scene SCENE_DIR
"""

import argparse
import json
import os

from ngp_tpu_torch.data.convert import nsvf_to_transforms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=".", help="NSVF scene folder")
    ap.add_argument("--aabb_scale", default=2, type=int)
    args = ap.parse_args(argv)

    splits = nsvf_to_transforms(args.scene, args.aabb_scale)
    for name, data in splits.items():
        out = os.path.join(args.scene, f"transforms_{name}.json")
        print(f"{len(data['frames'])} {name} frames -> {out}")
        with open(out, "w") as f:
            json.dump(data, f, indent=2)


if __name__ == "__main__":
    main()
