"""Observability: EMA timers and throughput meters, the port's copy of
``ngp_tpu/utils/meters.py``.

The reference keeps host-side EMA timers (``Ema``, ``common.h:315-365``;
``m_training_prep_ms/m_training_ms/...``, ``testbed.h:928-933``) and a loss
graph ring buffer (``update_loss_graph``, ``testbed.cu:3802``). Reading a
step's loss on the host would wait for the device every step, so the
meters take one adapt window at a time (``NerfEngine.train`` reads each
window's metrics one window late) and average over windows.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field


class Ema:
    """Time-based exponential moving average with the reference's
    half-life parameterization (``common.h:315-365``)."""

    def __init__(self, half_life_s: float = 1.0):
        self.half_life_s = half_life_s
        self.value = 0.0
        self._last_t: float | None = None

    def update(self, v: float, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if self._last_t is None:
            self.value = v
        else:
            dt = max(now - self._last_t, 0.0)
            a = 0.5 ** (dt / self.half_life_s) if self.half_life_s > 0 else 0.0
            self.value = a * self.value + (1.0 - a) * v
        self._last_t = now
        return self.value


@dataclass
class TrainMeters:
    """Per-engine training meters: loss EMA, loss graph ring buffer,
    samples/s and rays/s over sync windows, prep/train ms EMAs."""

    loss_half_life_steps: float = 16.0
    graph_capacity: int = 256
    loss_ema: float = 0.0
    n_loss_updates: int = 0
    loss_graph: list = field(default_factory=list)
    samples_per_s: Ema = field(default_factory=lambda: Ema(5.0))
    rays_per_s: Ema = field(default_factory=lambda: Ema(5.0))
    step_ms: Ema = field(default_factory=lambda: Ema(5.0))
    prep_ms: Ema = field(default_factory=lambda: Ema(5.0))

    def update_loss(self, loss: float) -> float:
        a = 0.5 ** (1.0 / self.loss_half_life_steps)
        if self.n_loss_updates == 0:
            self.loss_ema = loss
        else:
            self.loss_ema = a * self.loss_ema + (1 - a) * loss
        self.n_loss_updates += 1
        self.loss_graph.append(loss)
        if len(self.loss_graph) > self.graph_capacity:
            del self.loss_graph[: len(self.loss_graph) - self.graph_capacity]
        return self.loss_ema

    def update_window(self, n_steps: int, samples: float, rays: float,
                      elapsed_s: float, prep_s: float = 0.0) -> None:
        if elapsed_s <= 0 or n_steps <= 0:
            return
        self.samples_per_s.update(samples / elapsed_s)
        self.rays_per_s.update(rays / elapsed_s)
        self.step_ms.update(elapsed_s / n_steps * 1e3)
        if prep_s > 0:
            self.prep_ms.update(prep_s * 1e3)

    @property
    def psnr(self) -> float:
        """PSNR from the L2-ish loss EMA, like the reference's GUI readout
        (``-10·log10(loss)``, ``testbed.cu:410``)."""
        return -10.0 * math.log10(max(self.loss_ema, 1e-20))

    def snapshot_dict(self) -> dict:
        return {
            "loss_ema": self.loss_ema,
            "n_loss_updates": self.n_loss_updates,
            "samples_per_s": self.samples_per_s.value,
            "rays_per_s": self.rays_per_s.value,
            "step_ms": self.step_ms.value,
            "prep_ms": self.prep_ms.value,
        }


class MetricsLogger:
    """Append-only JSONL metrics file (the reference keeps its loss graph
    in the GUI only; a run from the command line needs a file)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, **kv) -> None:
        rec = {"step": int(step), "t": time.time()}
        rec.update({k: float(v) for k, v in kv.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
