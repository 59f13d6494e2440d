"""The interactive web viewer: train while you look, in the browser
(``utils/viewer.py``; the counterpart of the reference's ImGui window,
``src/testbed.cu:1003-2743``).

    python -m ngp_tpu_torch.scripts.viewer SCENE --port 8080 [--device cpu]

``--port 0`` takes a free port; the line ``ngp_tpu_torch viewer on
http://HOST:PORT/`` names it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scene")
    p.add_argument("--mode", default=None, choices=["nerf", "sdf", "image", "volume"])
    p.add_argument("--network", default=None, help="network config json")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--load_snapshot", default=None)
    p.add_argument("--train_steps_per_frame", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ngp_tpu_torch.testbed import Testbed
    from ngp_tpu_torch.utils.viewer import serve

    kw = {"device": args.device}
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    tb = Testbed(mode=args.mode, scene=args.scene, config=args.network, **kw)
    if args.load_snapshot:
        tb.load_snapshot(args.load_snapshot)
    serve(tb, args.host, args.port, n_train_steps=args.train_steps_per_frame)


if __name__ == "__main__":
    main()
