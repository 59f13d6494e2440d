"""2D image fitting, the port of ``ngp_tpu/engines/image.py`` (the
reference's ``src/testbed_image.cu``).

One hash-encoded MLP regresses pixel position → colour. Training positions
come from ``ops/image_sampler.py``, are snapped to texel centres and served
in sRGB unless ``linear_colors`` (``eval_image_kernel_and_snap``,
``testbed_image.cu:167-213``). A step is ``train.Trainer.training_step``:
B1 forward and the fused grid backward on the card.

The image stays on the engine's device in the dtype it was given: a numpy
array from ``data/image_loader.load_image`` is float32; a gigapixel image
may be float16 to halve its memory, as the reference stores it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ngp_tpu_torch.device import resolve_device
from ngp_tpu_torch.models.factory import (
    NetworkWithInputEncoding,
    create_loss,
    create_network_with_input_encoding,
)
from ngp_tpu_torch.ops.image_sampler import sample_positions
from ngp_tpu_torch.ops.tonemap import srgb_to_linear
from ngp_tpu_torch.train import Trainer, TrainState

CHUNK = 1 << 18  # positions a render or score call evaluates at once


def linear_to_srgb_in_dtype(x: torch.Tensor) -> torch.Tensor:
    """``ops/tonemap.linear_to_srgb`` with its constants rounded to ``x``'s
    dtype first, as the JAX package's weak-typed scalars are: on float16
    texels it then equals the JAX curve bit for bit (torch would keep the
    unrounded scalars in its float32 arithmetic)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype).item()

    return torch.where(x <= c(0.0031308), c(12.92) * x,
                       c(1.055) * torch.clamp_min(x, c(1e-9)) ** c(1.0 / 2.4) - c(0.055))


def eval_image_and_snap(image: torch.Tensor, positions: torch.Tensor,
                        snap_to_pixel_centers: bool = True,
                        linear_colors: bool = False):
    """Training targets of ``positions`` (N, 2) in [0, 1]² from ``image``
    (H, W, 4) linear; returns (positions', (N, 3) targets).

    Snapping moves each position to its texel's centre and takes that
    texel; otherwise the target is bilinear (float32 weights, so a float16
    image gives float32 targets). Colours go to sRGB unless
    ``linear_colors``, in the targets' dtype, as the JAX function computes
    them."""
    H, W = image.shape[:2]
    x, y = positions[:, 0], positions[:, 1]  # column by column: no (W, H) tensor to copy
    if snap_to_pixel_centers:
        ix = torch.floor(x * W).to(torch.int32)
        iy = torch.floor(y * H).to(torch.int32)
        positions = torch.stack([(ix.to(torch.float32) + 0.5) / W,
                                 (iy.to(torch.float32) + 0.5) / H], dim=-1)
        val = image[iy.clamp(0, H - 1).long(), ix.clamp(0, W - 1).long()]
    else:
        def top(r):  # r − (1 + 1e-4), rounded in float32 as the JAX function does
            return float(np.float32(r) - np.float32(1.0 + 1e-4))

        px = torch.clamp(x * W - 0.5, 0.0, top(W))
        py = torch.clamp(y * H - 0.5, 0.0, top(H))
        x0, y0 = px.to(torch.int32), py.to(torch.int32)
        wx = (px - x0.to(torch.float32))[:, None]
        wy = (py - y0.to(torch.float32))[:, None]
        x0, y0 = x0.clamp(0, W - 2).long(), y0.clamp(0, H - 2).long()
        val = ((1 - wx) * (1 - wy) * image[y0, x0]
               + wx * (1 - wy) * image[y0, x0 + 1]
               + (1 - wx) * wy * image[y0 + 1, x0]
               + wx * wy * image[y0 + 1, x0 + 1])
    rgb = val[:, :3]
    if not linear_colors:
        rgb = linear_to_srgb_in_dtype(rgb)
    return positions, rgb


def texel_centers(width: int, height: int, start: int, stop: int, device) -> torch.Tensor:
    """Positions (stop − start, 2) of the texel centres ``start:stop`` of a
    width × height grid in row-major order, float32 as the JAX engine makes
    them: ``(x + 0.5) / W``, ``(y + 0.5) / H``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    x = ((idx % width).to(torch.float32) + 0.5) / width
    y = ((idx // width).to(torch.float32) + 0.5) / height
    return torch.stack([x, y], dim=-1)


@dataclass
class ImageEngine:
    """``ImageEngine(config, image, batch_size=2^18, random_mode=
    "Stratified", snap_to_pixel_centers=True, linear_colors=False,
    seed=1337, device="cuda")``: ``image`` (H, W, 4) linear, numpy or a
    tensor. ``random_mode``: Halton, Sobol, Uniform or Stratified (Uniform
    and Stratified draw their own stream, ``ops/image_sampler.py``)."""

    config: dict
    image: Any
    batch_size: int = 1 << 18
    random_mode: str = "Stratified"
    snap_to_pixel_centers: bool = True
    linear_colors: bool = False
    seed: int = 1337
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.config = copy.deepcopy(self.config)
        self.image = torch.as_tensor(self.image, device=self.device)
        self.trainer = Trainer(
            create_loss(self.config.get("loss", {"otype": "RelativeL2"})),
            self.config["optimizer"],
        )

    def _new_network(self) -> NetworkWithInputEncoding:
        return create_network_with_input_encoding(2, 3, self.config, self.device)

    def init_state(self) -> TrainState:
        """Step 0: a model with parameters drawn from a CPU
        ``torch.Generator`` seeded with ``self.seed``, zero Adam moments."""
        net = self._new_network()
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        return TrainState.create(net)

    def make_batch(self, step: int, batch_size: int):
        """(positions, targets) of training step ``step``."""
        pos = sample_positions(self.random_mode, step, batch_size, self.seed,
                               self.device)
        return eval_image_and_snap(self.image, pos, self.snap_to_pixel_centers,
                                   self.linear_colors)

    def train(self, state: TrainState, n_steps: int,
              batch_size: int | None = None) -> tuple[TrainState, torch.Tensor]:
        """``n_steps`` steps on ``state`` (in place); returns it and the
        steps' losses, an (n_steps,) float32 tensor on the device that no
        host read has waited for."""
        batch_size = batch_size or self.batch_size
        losses = []
        for _ in range(n_steps):
            inputs, targets = self.make_batch(state.step, batch_size)
            losses.append(self.trainer.training_step(state, inputs, targets))
        if not losses:
            return state, torch.zeros((0,), dtype=torch.float32, device=self.device)
        return state, torch.stack(losses)

    @torch.no_grad()
    def render(self, state: TrainState, width: int | None = None,
               height: int | None = None) -> torch.Tensor:
        """The served model at the texel centres of a width × height grid
        (the image's by default) → (H, W, 3) linear RGB on the device: the
        network's output is sRGB unless ``linear_colors``."""
        H = height or self.image.shape[0]
        W = width or self.image.shape[1]
        model = state.inference_model()
        out = torch.empty((H * W, 3), dtype=torch.float32, device=self.device)
        for i in range(0, H * W, CHUNK):
            stop = min(i + CHUNK, H * W)
            out[i:stop] = model(texel_centers(W, H, i, stop, self.device))[:, :3]
        rgb = out.reshape(H, W, 3)
        return rgb if self.linear_colors else srgb_to_linear(rgb)

    @torch.no_grad()
    def compute_mse(self, state: TrainState, quantize_to_byte: bool = False) -> float:
        """Mean squared error over every texel in the training colour space
        (sRGB unless ``linear_colors``), the reference's
        ``compute_image_mse`` (``testbed_image.cu:465-528``); PSNR =
        −10·log10(mse). Chunks are summed on the device and read once."""
        H, W = self.image.shape[:2]
        model = state.inference_model()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, H * W, CHUNK):
            pos = texel_centers(W, H, i, min(i + CHUNK, H * W), self.device)
            p, targets = eval_image_and_snap(self.image, pos, True, self.linear_colors)
            pred = model(p)[:, :3]
            if quantize_to_byte:
                pred = torch.round(torch.clamp(pred, 0, 1) * 255.0) / 255.0
            d = targets - pred
            total += torch.sum(d * d) / 3.0
        return float(total) / (H * W)

    # -- native snapshots (the JAX package's document)

    def save_snapshot(self, path: str, state: TrainState) -> None:
        """Write the JAX engine's native snapshot (``utils/snapshot.py``;
        zlib-compressed for ``.ingp``): mode, network config, training step
        (int32), parameters and served (EMA) parameters as JAX trees."""
        from ngp_tpu_torch.interop import export_jax_params
        from ngp_tpu_torch.utils.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": "image",
            "network_config": self.config,
            "snapshot": {
                "training_step": np.asarray(state.step, np.int32),
                "params": export_jax_params(state.model),
                "ema_params": export_jax_params(state.inference_model()),
            },
        })

    def load_snapshot(self, path: str) -> TrainState:
        """Read a native snapshot, the port's or the JAX package's.
        Optimizer moments start at zero, as the JAX package's
        ``load_snapshot`` starts them."""
        from ngp_tpu_torch.interop import load_jax_params
        from ngp_tpu_torch.utils.snapshot import load_snapshot

        snap = load_snapshot(path)["snapshot"]
        net = load_jax_params(self._new_network(), snap["params"])
        state = TrainState.create(net, int(snap["training_step"]))
        if self.trainer.opt_cfg.ema_decay is not None:
            state.ema = load_jax_params(copy.deepcopy(net), snap["ema_params"]
                                        ).requires_grad_(False)
        return state
