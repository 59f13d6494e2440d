"""The Block-NeRF street CLI, the fork's ``--train``/``--render`` entry
point (``src/main.cu:63-155``): train a NeRF a city block, then play a
drive-through back along the recorded poses by hot-swapping the block
models (``ngp_tpu_torch/blocknerf.py``).

    python -m ngp_tpu_torch.scripts.blocknerf --data ROOT --train --render \\
        --out DIR [--device cpu]

``ROOT`` holds ``blocks/b*/pose.csv`` (and ``setting.json``) and
``images/``. Frames are written as ``DIR/frame_%04d.png``; the last line is
``kernel launches: {...}``, as ``python -m ngp_tpu_torch.run`` ends.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True, help="root with blocks/b*/")
    p.add_argument("--train", action="store_true")
    p.add_argument("--render", action="store_true")
    p.add_argument("--n_steps", type=int, default=None,
                   help="override setting.json training_steps")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--network", default=None,
                   help="network config json (default: instant-ngp's base.json)")
    p.add_argument("--out", default="blocknerf_frames",
                   help="render output directory (png sequence)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--block_shard", default=None, metavar="I/N",
                   help="train only every Nth block starting at I (e.g. 0/4)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not (args.train or args.render):
        p.error("pass --train and/or --render (as the fork's main.cu)")

    from ngp_tpu_torch.blocknerf import (
        BlockNerfRenderer,
        playback_world_poses,
        train_street_view_nerf,
    )
    from ngp_tpu_torch.config import load_config
    from ngp_tpu_torch.data.png import write_png
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    reset_launches()
    kw = {"device": args.device}
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    if args.train:
        shard = None
        if args.block_shard:
            i, n = args.block_shard.split("/")
            shard = (int(i), int(n))
        config = load_config(args.network) if args.network else None
        snaps = train_street_view_nerf(args.data, config=config, n_steps_override=args.n_steps,
                                       block_shard=shard, log=lambda s: print(s, flush=True),
                                       **kw)
        print(f"trained {len(snaps)} blocks", flush=True)
    if args.render:
        r = BlockNerfRenderer(args.data, **kw)
        os.makedirs(args.out, exist_ok=True)
        for i, xform in enumerate(playback_world_poses(args.data, args.n_frames)):
            img, _ = r.render_at(xform, args.width, args.height)
            write_png(os.path.join(args.out, f"frame_{i:04d}.png"),
                      np.clip(img * 255.0, 0, 255).astype(np.uint8))
        print(f"rendered {args.n_frames} frames to {args.out}", flush=True)
    print(f"kernel launches: {json.dumps(launch_counts())}", flush=True)


if __name__ == "__main__":
    main()
