"""Convert a Record3D capture to transforms.json (reference
``scripts/record3d2nerf.py``).

    python -m ngp_tpu_torch.scripts.record3d2nerf --scene CAPTURE_DIR
"""

import argparse
import json
import os

from ngp_tpu_torch.data.convert import record3d_to_transforms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", required=True, help="Record3D capture folder")
    ap.add_argument("--subsample", default=1, type=int)
    args = ap.parse_args(argv)

    out = record3d_to_transforms(args.scene, args.subsample)
    path = os.path.join(args.scene, "transforms.json")
    print(f"{len(out['frames'])} frames -> {path}")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
