"""Train, evaluate and export a NeRF scene, an SDF, an image fit or a
volume from the command line, the port of ``scripts/run.py`` in nerf, sdf,
image and volume modes (the reference's ``scripts/run.py``). NeRF: train
on a capture, score a training view and held-out views, take a
screenshot, export a marching-cubes mesh, render a camera path as video
frames, and save and load snapshots. SDF (an ASCII ``.obj`` or binary ``.stl`` mesh): fit it,
print its IoU, take a screenshot (``--render_mode`` headlight, the
default, or shade, ao, normals, positions, cost), export the learned
surface, and save and load snapshots. Image (a ``.png``, ``.jpg``,
``.exr`` or ``.bin`` scene): fit it, print its MSE and PSNR over every texel, take a
screenshot at ``--screenshot_w`` × ``--screenshot_h``, and save and load
snapshots. Volume (an ``.nvdb`` or ``.npy`` density volume): fit it (no
score line, as in the JAX CLI), take a screenshot of the learned field
from the default camera, and save and load snapshots. The NeRF-only
flags raise or are ignored as the JAX package's CLI treats them.

Examples:

    python -m ngp_tpu_torch.run capture/transforms_train.json --n_steps 2000 \\
        --test_transforms capture/transforms_test.json \\
        --save_snapshot out/scene.ingp --screenshot out/shot.png
    python -m ngp_tpu_torch.run capture/transforms_train.json \\
        --load_snapshot out/scene.ingp --n_steps 0 --save_mesh out/mesh.obj \\
        --video_camera_path path.json --video_output out/frames
    python -m ngp_tpu_torch.run image.bin --n_steps 1000 --screenshot out/fit.png
    python -m ngp_tpu_torch.run mesh.obj --n_steps 1000 --save_mesh out/mesh.obj \\
        --screenshot out/normals.png --render_mode normals
    python -m ngp_tpu_torch.run cloud.nvdb --n_steps 1000 --screenshot out/cloud.png

It runs on the card unless ``--device cpu`` is given. It differs from the
JAX package's CLI in these: ``--device`` takes the place of the JAX
platform's environment; ``--profile`` writes a ``torch.profiler`` Chrome
trace; ``--metrics_file`` appends the training meters as JSONL (one line a
16-step window, NeRF only); ``--render_mode`` also takes the SDF modes
(the JAX CLI's SDF screenshot is always the headlight shade); images are
written by the port's own PNG and EXR writers (other extensions raise); there is no compile cache and no
multi-host rendezvous. The last line printed counts the launches of each CUDA kernel
(zero on the CPU, where the kernels' plain versions run).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import time

import numpy as np
import torch


def apply_tonemap(img: np.ndarray, curve: str = "identity",
                  exposure_ev: float = 0.0) -> np.ndarray:
    """Render epilogue: sRGB frame → linear → exposure → tonemap → sRGB
    (``render_frame_epilogue``'s tonemap stage, ``src/render_buffer.cu``)."""
    if curve == "identity" and exposure_ev == 0.0:
        return img
    from ngp_tpu_torch.ops.tonemap import TONEMAPS, linear_to_srgb, srgb_to_linear

    lin = srgb_to_linear(torch.from_numpy(np.clip(img, 0.0, 1.0))) * (2.0 ** exposure_ev)
    if curve != "identity":
        return np.clip(TONEMAPS[curve](lin).numpy(), 0.0, 1.0)
    return np.clip(linear_to_srgb(lin).numpy(), 0.0, 1.0)


def write_image(path: str, img) -> None:
    """``.exr``: float16 EXR; ``.png``: 8-bit PNG, ``.jpg``/``.jpeg``: JPEG
    at PIL's default quality 75, each of ``clip(img, 0, 1)·255`` truncated,
    as the JAX package's CLI quantises. Other extensions raise."""
    img = np.asarray(img)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from ngp_tpu_torch.data.exr import write_exr

        write_exr(path, img.astype(np.float32))
    elif ext == ".png":
        from ngp_tpu_torch.data.png import write_png

        write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
    elif ext in (".jpg", ".jpeg"):
        from ngp_tpu_torch.data.jpeg import write_jpeg

        write_jpeg(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
    else:
        raise ValueError(f"cannot write {path!r}: the port writes .png, .jpg and .exr images")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scene", nargs="?", default="",
                   help="scene path: a transforms.json or a directory of them "
                        "(NeRF), an obj/stl mesh (SDF), an image file (image), or an "
                        "nvdb/npy density volume (volume)")
    p.add_argument("--mode", default=None, choices=["nerf", "sdf", "image", "volume"])
    p.add_argument("--network", default=None, help="network config json")
    p.add_argument("--n_steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--load_snapshot", default=None)
    p.add_argument("--save_snapshot", default=None)
    p.add_argument("--screenshot", default=None, help="render a view to this path")
    p.add_argument("--screenshot_w", type=int, default=512)
    p.add_argument("--screenshot_h", type=int, default=512)
    p.add_argument("--save_mesh", default=None, help="marching-cubes export (obj/ply)")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--marching_cubes_density_thresh", type=float, default=2.5)
    p.add_argument("--test_view", type=int, default=0,
                   help="training view index for the PSNR eval and the screenshot")
    p.add_argument("--eval_stride", type=int, default=2)
    p.add_argument("--holdout_every", type=int, default=0,
                   help="exclude every Nth view from training and report "
                        "held-out PSNR/SSIM on them")
    p.add_argument("--test_transforms", default=None,
                   help="held-out transforms.json: render every view and "
                        "report PSNR/SSIM (reference run.py:208-266)")
    p.add_argument("--test_spp", type=int, default=1)
    p.add_argument("--test_max_views", type=int, default=None)
    p.add_argument("--flip", action="store_true",
                   help="also compute the FLIP perceptual metric per view")
    p.add_argument("--video_camera_path", default=None,
                   help="camera-path json to render as a flythrough video")
    p.add_argument("--video_n_seconds", type=float, default=4.0)
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_output", default="video.mp4",
                   help="output mp4 (needs ffmpeg) or a directory for pngs")
    p.add_argument("--video_w", type=int, default=640)
    p.add_argument("--video_h", type=int, default=360)
    p.add_argument("--video_spp", type=int, default=1)
    p.add_argument("--render_mode", default=None,
                   choices=["shade", "depth", "normals", "positions",
                            "cost", "ao", "encoding", "headlight"],
                   help="screenshot render mode (ERenderMode). NeRF: shade "
                        "(default), or the debug modes depth, normals, "
                        "positions, cost, ao and encoding, rendered at a "
                        "training view's camera; SDF: headlight (default), "
                        "shade, ao, normals, positions or cost")
    p.add_argument("--tonemap", default="identity",
                   choices=["identity", "aces", "hable", "reinhard"],
                   help="tonemap curve for screenshots and video frames")
    p.add_argument("--exposure", type=float, default=0.0,
                   help="EV offset applied before tonemapping")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of a few train steps here")
    p.add_argument("--metrics_file", default=None,
                   help="append the training meters here as JSONL")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _train(tb, args) -> None:
    """``n_steps`` steps; under ``--profile`` the first 16 outside the trace
    (warm-up), the next 8 traced, the rest after."""
    eng = tb.engine
    if tb.mode in ("image", "sdf", "volume"):
        train = tb.train
    else:
        def train(n):
            tb.state, tb.grid, metrics = eng.train(tb.state, tb.grid, n,
                                                   metrics_file=args.metrics_file)
            tb.loss = float(metrics["loss"])
    if not args.profile:
        train(args.n_steps)
        return
    from torch.profiler import ProfilerActivity, profile

    warm = min(args.n_steps, 16)
    traced = min(max(args.n_steps - warm, 0), 8)
    train(warm)
    if traced:
        activities = [ProfilerActivity.CPU]
        if eng.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            train(traced)
            _sync(eng.device)
        os.makedirs(os.path.dirname(args.profile) or ".", exist_ok=True)
        prof.export_chrome_trace(args.profile)
        print(f"profiler trace written to {args.profile}", flush=True)
    rest = args.n_steps - warm - traced
    if rest > 0:
        train(rest)


def _render_video(tb, args) -> None:
    from ngp_tpu_torch.utils.camera_path import CameraPath

    path = CameraPath.load(args.video_camera_path)
    n_frames = max(int(args.video_n_seconds * args.video_fps), 1)
    out = args.video_output
    is_dir = not out.lower().endswith((".mp4", ".avi", ".mkv"))
    frames_dir = out if is_dir else out + "_frames"
    os.makedirs(frames_dir, exist_ok=True)
    t0 = time.time()
    for i in range(n_frames):
        t = i / max(n_frames - (0 if path.loop else 1), 1)
        kf = path.eval_camera_path(t)
        f = 0.5 * args.video_h / np.tan(0.5 * np.radians(kf.fov))
        rgb, _, _ = tb.engine.render_view(
            tb.state, tb.grid, kf.matrix(), (f, f), width=args.video_w,
            height=args.video_h, spp=args.video_spp,
            snap_to_pixel_centers=args.video_spp <= 1, seed=i)
        img = apply_tonemap(rgb.cpu().numpy(), args.tonemap, args.exposure)
        write_image(os.path.join(frames_dir, f"frame_{i:04d}.png"), img)
    print(f"rendered {n_frames} frames in {time.time() - t0:.1f}s", flush=True)
    if not is_dir:
        if shutil.which("ffmpeg"):
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(args.video_fps),
                 "-i", os.path.join(frames_dir, "frame_%04d.png"), "-pix_fmt", "yuv420p",
                 out],
                check=True)
            print(f"wrote {out}", flush=True)
        else:
            print(f"ffmpeg not found; frames left in {frames_dir}", flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.testbed import SDF_EYE, SDF_FOV_DEG, SDF_LOOKAT, Testbed

    reset_launches()
    kw = {"seed": args.seed, "device": args.device}
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    holdout_ds = None
    if args.holdout_every and args.holdout_every > 1:
        # loaded as Testbed loads it, so the frame indices match
        full_ds = load_nerf(args.scene)
        all_idx = list(range(full_ds.n_images))
        test_idx = all_idx[:: args.holdout_every]
        train_idx = [i for i in all_idx if i not in set(test_idx)]
        holdout_ds = full_ds.subset(test_idx)
        kw["frame_subset"] = train_idx
        print(f"holdout: training on {len(train_idx)} views, "
              f"evaluating on {len(test_idx)}", flush=True)
    tb = Testbed(mode=args.mode, scene=args.scene or None, config=args.network, **kw)

    if args.metrics_file and tb.mode in ("image", "sdf", "volume"):
        raise ValueError(f"--metrics_file records NeRF training meters; {tb.mode} mode "
                         "has none")

    if args.load_snapshot:
        tb.load_snapshot(args.load_snapshot)
        print(f"loaded snapshot at step {tb.training_step}", flush=True)

    if args.n_steps > 0 and tb.engine is not None:
        if args.metrics_file:
            os.makedirs(os.path.dirname(args.metrics_file) or ".", exist_ok=True)
        t0 = time.time()
        _train(tb, args)
        _sync(tb.engine.device)
        dt = time.time() - t0
        print(f"trained {args.n_steps} steps in {dt:.1f}s "
              f"({args.n_steps / dt:.2f} steps/s), loss={tb.loss:.6f}", flush=True)

    if tb.mode == "image":
        mse = tb.compute_image_mse()
        print(f"MSE: {mse:.6f}  PSNR: {-10 * math.log10(max(mse, 1e-12)):.2f} dB", flush=True)
    elif tb.mode == "sdf":
        print(f"IoU: {tb.calculate_iou():.4f}", flush=True)
    elif tb.mode == "nerf" and tb.engine is not None:
        psnr = tb.psnr(args.test_view, stride=args.eval_stride)
        print(f"PSNR (train view {args.test_view}): {psnr:.2f} dB", flush=True)

    if args.test_transforms or holdout_ds is not None:
        if args.test_transforms:
            test_ds, label = load_nerf(args.test_transforms), "test_transforms"
        else:
            test_ds, label = holdout_ds, f"holdout(every {args.holdout_every})"
        res = tb.engine.eval_test_transforms(
            tb.state, tb.grid, test_ds, spp=args.test_spp, stride=args.eval_stride,
            max_views=args.test_max_views, compute_flip=args.flip)
        flip_str = f" FLIP={res['flip']:.4f}" if args.flip else ""
        print(f"{label}: PSNR={res['psnr']:.2f} "
              f"[min={res['min_psnr']:.2f} max={res['max_psnr']:.2f}] "
              f"SSIM={res['ssim']:.4f}{flip_str} over {res['n_views']} views", flush=True)

    if args.video_camera_path:
        _render_video(tb, args)

    if args.save_snapshot:
        os.makedirs(os.path.dirname(args.save_snapshot) or ".", exist_ok=True)
        tb.save_snapshot(args.save_snapshot)
        print(f"saved snapshot to {args.save_snapshot}", flush=True)

    if args.screenshot:
        os.makedirs(os.path.dirname(args.screenshot) or ".", exist_ok=True)
        if tb.mode in ("image", "volume") or (tb.mode == "sdf"
                                              and args.render_mode in (None, "headlight")):
            img = tb.render(args.screenshot_w, args.screenshot_h)
        elif tb.mode == "sdf":
            img = tb.engine.render_image(
                tb.state, SDF_EYE, SDF_LOOKAT, (args.screenshot_w, args.screenshot_h),
                SDF_FOV_DEG, mode=args.render_mode)[0].cpu().numpy()
        elif args.render_mode not in (None, "shade"):
            img = tb.engine.render_image(tb.state, tb.grid, args.test_view,
                                         mode=args.render_mode).cpu().numpy()
        else:
            img = tb.render(args.screenshot_w, args.screenshot_h,
                            training_view=args.test_view)
        write_image(args.screenshot, apply_tonemap(img, args.tonemap, args.exposure))
        print(f"wrote {args.screenshot}", flush=True)

    if args.save_mesh:
        from ngp_tpu_torch.ops.marching_cubes import save_obj, save_ply

        verts, faces = tb.compute_marching_cubes_mesh(
            args.marching_cubes_res, args.marching_cubes_density_thresh)
        os.makedirs(os.path.dirname(args.save_mesh) or ".", exist_ok=True)
        (save_ply if args.save_mesh.endswith(".ply") else save_obj)(
            args.save_mesh, verts, faces)
        print(f"wrote {args.save_mesh} ({len(verts)} verts, {len(faces)} faces)", flush=True)

    print(f"kernel launches: {json.dumps(launch_counts())}", flush=True)


if __name__ == "__main__":
    main()
