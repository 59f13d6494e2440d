"""Training state, the port of ``ngp_tpu/train.py:TrainState``."""

from __future__ import annotations

import copy
from dataclasses import dataclass

from torch import nn

from ngp_tpu_torch.optim import GROUPS, AdamState, adam_init, param_groups


@dataclass
class TrainState:
    """The training step, the model (parameters being trained), the Adam
    state of each group (``"dense"``, ``"grid"``; see ``optim.py``) and
    the EMA copy of the model served for inference. The engine updates all
    of them in place; ``step`` counts the updates applied.

    ``ema`` is None until the first update copies the model into it (the
    JAX package's ``ema_init`` at the parameters the first update starts
    from) and stays None without an ``Ema`` optimizer; until then the
    model itself is served."""

    step: int
    model: nn.Module
    opt_state: dict[str, AdamState]
    ema: nn.Module | None

    @staticmethod
    def create(model: nn.Module, step: int = 0) -> "TrainState":
        """Zero moments and no EMA copy yet."""
        groups = param_groups(model)
        opt = {g: adam_init([p for _, p in groups[g]]) for g in GROUPS}
        return TrainState(step, model, opt, None)

    def start_ema(self):
        """Copy the model into ``ema`` (before the first update)."""
        self.ema = copy.deepcopy(self.model).requires_grad_(False)

    def inference_model(self) -> nn.Module:
        """The EMA-averaged model where there is one, else the model."""
        return self.ema if self.ema is not None else self.model
