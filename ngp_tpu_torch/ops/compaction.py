"""Sample compaction, the forward of ``ngp_tpu/ops/compaction.py``.

The network runs only on the first ``budget`` valid slots of a flattened
slot array (callers flatten k-major, so an overflow drops the deepest march
steps across all rays). The JAX package finds those slots with a stable
flag sort, to keep static shapes on the TPU; here they are ``cumsum`` +
``nonzero``, and the compact row count is whatever fits, ≤ ``budget``.

    plan = compaction_plan(valid.reshape(-1), budget)
    x_c  = compact_rows(x.reshape(-1, C), plan)       # (n_live, C)
    y    = expand_rows(network(x_c), plan)            # (NK, C), 0 where dropped
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompactionPlan(NamedTuple):
    cidx: torch.Tensor  # (n_live,) int64 slot index of compact row j
    keep: torch.Tensor  # (NK,) bool slot is valid and its rank fits the budget
    n_valid: int  # valid slots, may exceed the budget

    @property
    def n_live(self) -> int:
        return int(self.cidx.shape[0])


def compaction_plan(valid: torch.Tensor, budget: int) -> CompactionPlan:
    """Index maps for compacting the (NK,) bool ``valid`` slots into at most
    ``budget`` rows, in slot order."""
    rank_raw = torch.cumsum(valid, dim=0) - 1
    keep = valid & (rank_raw < budget)
    cidx = torch.nonzero(keep).reshape(-1)
    n_valid = int(rank_raw[-1]) + 1 if valid.numel() else 0
    return CompactionPlan(cidx, keep, n_valid)


def compact_rows(x: torch.Tensor, plan: CompactionPlan) -> torch.Tensor:
    """(NK, C) → (n_live, C): row j = x[cidx[j]]."""
    return x[plan.cidx]


def expand_rows(y: torch.Tensor, plan: CompactionPlan) -> torch.Tensor:
    """(n_live, C) → (NK, C): row j goes to slot cidx[j], other slots 0."""
    out = y.new_zeros((plan.keep.shape[0],) + tuple(y.shape[1:]))
    out[plan.cidx] = y
    return out
