"""Convert a COLMAP text export to transforms.json (the reference's
``scripts/colmap2nerf.py`` conversion path; with ``--run_colmap`` the
installed ``colmap`` binary makes the text export first).

    python -m ngp_tpu_torch.scripts.colmap2nerf --images images \\
        --text colmap_text --out transforms.json
"""

import argparse
import json
import os
import subprocess

from ngp_tpu_torch.data.convert import colmap_to_transforms


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", default="images", help="image folder")
    ap.add_argument("--text", default="colmap_text",
                    help="COLMAP text-model folder (cameras.txt/images.txt)")
    ap.add_argument("--aabb_scale", default=32, type=int,
                    choices=[1, 2, 4, 8, 16, 32, 64, 128])
    ap.add_argument("--skip_early", default=0, type=int)
    ap.add_argument("--keep_colmap_coords", action="store_true")
    ap.add_argument("--no_sharpness", action="store_true")
    ap.add_argument("--out", default="transforms.json")
    ap.add_argument("--run_colmap", action="store_true",
                    help="run the colmap binary first (feature_extractor + "
                         "matcher + mapper + model_converter)")
    ap.add_argument("--colmap_matcher", default="sequential",
                    choices=["exhaustive", "sequential", "spatial",
                             "transitive", "vocab_tree"])
    ap.add_argument("--colmap_db", default="colmap.db")
    ap.add_argument("--colmap_camera_model", default="OPENCV")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.run_colmap:
        db, img, txt = args.colmap_db, args.images, args.text
        sparse = db + "_sparse"
        cmds = [
            ["colmap", "feature_extractor", "--ImageReader.camera_model",
             args.colmap_camera_model, "--ImageReader.single_camera", "1",
             "--database_path", db, "--image_path", img],
            ["colmap", f"{args.colmap_matcher}_matcher", "--database_path", db],
            ["colmap", "mapper", "--database_path", db, "--image_path", img,
             "--output_path", sparse],
            ["colmap", "bundle_adjuster", "--input_path", f"{sparse}/0",
             "--output_path", f"{sparse}/0", "--BundleAdjustment.refine_principal_point", "1"],
            ["colmap", "model_converter", "--input_path", f"{sparse}/0",
             "--output_path", txt, "--output_type", "TXT"],
        ]
        os.makedirs(sparse, exist_ok=True)
        os.makedirs(txt, exist_ok=True)
        for c in cmds:
            print("==== running:", " ".join(c))
            subprocess.check_call(c)

    out = colmap_to_transforms(
        args.text, args.images, args.aabb_scale, args.skip_early,
        args.keep_colmap_coords, compute_sharpness=not args.no_sharpness,
    )
    print(f"{len(out['frames'])} frames -> {args.out}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
