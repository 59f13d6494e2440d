"""Bias-free MLP, the port of ``ngp_tpu/models/mlp.py`` (tcnn's
FullyFusedMLP semantics).

Numerics follow the JAX package: every product takes operands rounded to
bf16 and accumulates and returns float32 (``jnp.dot(bf16, bf16,
preferred_element_type=float32)``); hidden activations are rounded to bf16
again before the next product. Here the bf16-rounded values are kept in
float32 tensors and multiplied by ``torch.matmul`` in float32 with TF32
off (``device.resolve_device``): a bf16 matmul would round its output to
bf16 as well. The products are plain matrix products, left to PyTorch as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ngp_tpu_torch.device import resolve_device


def _leaky_relu(x):
    return torch.nn.functional.leaky_relu(x, 0.01)


def _squareplus(x):
    return 0.5 * (x + torch.sqrt(x * x + 4.0))


_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "leakyrelu": _leaky_relu,
    "exponential": torch.exp,
    "sigmoid": torch.sigmoid,
    "logistic": torch.sigmoid,
    "sine": torch.sin,
    "squareplus": _squareplus,
    "softplus": torch.nn.functional.softplus,
    "tanh": torch.tanh,
}


def activation_fn(name: str):
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bf16 (nearest even) and keep them float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class MLP(nn.Module):
    """``n_hidden_layers`` hidden products of width ``n_neurons`` with
    ``activation``, then an output product with ``output_activation``;
    ``n_hidden_layers == 0`` is one linear layer. Weights are stored
    ``(in, out)`` as in the JAX package."""

    def __init__(self, n_input_dims: int, n_output_dims: int,
                 n_neurons: int = 64, n_hidden_layers: int = 2,
                 activation: str = "ReLU", output_activation: str = "None",
                 device="cuda"):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.n_neurons = n_neurons
        self.n_hidden_layers = n_hidden_layers
        self.activation = activation
        self.output_activation = output_activation
        self._act = activation_fn(activation)
        self._out_act = activation_fn(output_activation)
        dev = resolve_device(device)
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros((a, b), dtype=torch.float32, device=dev))
            for a, b in self.layer_dims
        )

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        if self.n_hidden_layers == 0:
            return [(self.n_input_dims, self.n_output_dims)]
        dims = [(self.n_input_dims, self.n_neurons)]
        dims += [(self.n_neurons, self.n_neurons)] * (self.n_hidden_layers - 1)
        dims += [(self.n_neurons, self.n_output_dims)]
        return dims

    @property
    def n_params(self) -> int:
        return sum(a * b for a, b in self.layer_dims)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """He-uniform weights, drawn on the CPU from ``generator``."""
        for w in self.weights:
            bound = math.sqrt(6.0 / w.shape[0])
            w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = round_bf16(x)
        for w in self.weights[:-1]:
            h = round_bf16(self._act(h @ round_bf16(w)))
        return self._out_act(h @ round_bf16(self.weights[-1]))
