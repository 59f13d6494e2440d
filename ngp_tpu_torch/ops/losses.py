"""Per-element losses, the port of ``ngp_tpu/ops/losses.py`` (the
reference's per-ray RGB loss family, ``testbed_nerf.cu:207-284``). Each
returns elementwise values; autograd gives the reference's hand-written
gradients. A denominator the JAX package stops gradients through is
detached here."""

from __future__ import annotations

import torch


def l2(target, prediction):
    d = prediction - target
    return d * d


def relative_l2(target, prediction):
    d = prediction - target
    denom = (prediction * prediction).detach() + 1e-2
    return d * d / denom


def l1(target, prediction):
    return torch.abs(prediction - target)


def huber(target, prediction, alpha: float = 1.0):
    d = prediction - target
    ad = torch.abs(d)
    return torch.where(ad > alpha, ad - 0.5 * alpha, 0.5 / alpha * d * d)


def log_l1(target, prediction):
    return torch.log(torch.abs(prediction - target) + 1.0)


def smape(target, prediction):
    d = prediction - target
    denom = (0.5 * (torch.abs(prediction) + torch.abs(target))).detach() + 1e-2
    return torch.abs(d) / denom


def mape(target, prediction):
    d = prediction - target
    denom = torch.abs(prediction).detach() + 1e-2
    return torch.abs(d) / denom


_LOSSES = {
    "l2": l2,
    "relativel2": relative_l2,
    "l1": l1,
    "huber": huber,
    "logl1": log_l1,
    "smape": smape,
    "mape": mape,
}


def get_loss(otype: str):
    key = otype.lower().replace("_", "")
    if key not in _LOSSES:
        raise ValueError(f"unknown loss {otype!r}")
    return _LOSSES[key]
