"""Mesh vertex optimisation against a density field, the port of
``ngp_tpu/ops/mesh_opt.py`` (the reference's ``compute_mesh_opt_gradients``
and its ``MeshState`` vertex Adam, marching_cubes.cu:640-774,
testbed.h:519-547). Each vertex takes the gradient

  g_i = n̂(∇σ(v_i))·sign(σ(v_i) − thresh)·k_density
      + (v_i − ring_avg_i)·k_smooth − n̂(normal_i)·k_inflate

(k_smooth 2048, k_density 128, k_inflate 1 by default) and Adam steps the
vertices. The 1-ring and normal sums are the reference's atomic adds
(``accumulate_1ring``), here ``index_add_``: on the card its float32
additions land in any order, on the CPU in the order of the face list
(the JAX package sums through a sort, so sums of more than two terms may
differ in their last bits).
"""

from __future__ import annotations

import numpy as np
import torch


def vertex_ring_and_normals(verts: torch.Tensor, faces: torch.Tensor):
    """Per-vertex 1-ring average (V, 3) and area-weighted normal (V, 3):
    each face adds its two other corners (a weight of 2) to each corner's
    ring and its unnormalised face normal to each corner's normal."""
    V = verts.shape[0]
    faces = faces.long()
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    pa, pb, pc = verts[a], verts[b], verts[c]
    fn = torch.linalg.cross(pb - pa, pc - pa)
    keys = torch.cat([a, b, c])
    ring_vals = torch.cat([pb + pc, pa + pc, pa + pb])
    ring4 = torch.cat([ring_vals, torch.full_like(ring_vals[:, :1], 2.0)], dim=1)
    ring = torch.zeros((V, 4), dtype=verts.dtype, device=verts.device).index_add_(0, keys, ring4)
    nrm = torch.zeros((V, 3), dtype=verts.dtype, device=verts.device).index_add_(
        0, keys, torch.cat([fn, fn, fn]))
    w = torch.clamp_min(ring[:, 3:4], 1.0)
    return ring[:, :3] / w, nrm


def mesh_opt_gradient(verts: torch.Tensor, faces: torch.Tensor, density: torch.Tensor,
                      density_grad: torch.Tensor, thresh: float, k_smooth: float = 2048.0,
                      k_density: float = 128.0, k_inflate: float = 1.0) -> torch.Tensor:
    """The per-vertex gradient (V, 3) of ``compute_mesh_opt_gradients_kernel``
    (marching_cubes.cu:710-741) from the density (V,) at the vertices and
    its gradient (V, 3)."""
    ring_avg, normals = vertex_ring_and_normals(verts, faces)
    smoothing = verts - ring_avg
    n_dens = density_grad / torch.clamp_min(
        torch.linalg.norm(density_grad, dim=-1, keepdim=True), 1e-12)
    n_vert = normals / torch.clamp_min(torch.linalg.norm(normals, dim=-1, keepdim=True), 1e-12)
    return (n_dens * torch.sign(density - thresh)[:, None] * k_density
            + smoothing * k_smooth - n_vert * k_inflate)


class VertexAdam:
    """Adam on the vertex positions as the JAX package steps them
    (``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 outside the root, the
    bias corrections in float32)."""

    def __init__(self, verts: torch.Tensor, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = torch.zeros_like(verts)
        self.nu = torch.zeros_like(verts)
        self.count = 0

    def step(self, verts: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        self.count += 1
        self.mu = (1.0 - self.b1) * grad + self.b1 * self.mu
        self.nu = (1.0 - self.b2) * (grad * grad) + self.b2 * self.nu
        one = np.float32(1.0)
        c1 = float(one - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(one - np.float32(self.b2) ** np.float32(self.count))
        update = (self.mu / c1) / (torch.sqrt(self.nu / c2) + self.eps)
        return verts + (-self.lr) * update


def optimize_mesh(density_and_grad, verts: torch.Tensor, faces: torch.Tensor, thresh: float,
                  n_steps: int = 10, learning_rate: float = 1e-4, k_smooth: float = 2048.0,
                  k_density: float = 128.0, k_inflate: float = 1.0) -> torch.Tensor:
    """``n_steps`` Adam steps on ``verts`` (V, 3); ``density_and_grad(v)``
    returns the density (V,) and its gradient (V, 3) at ``v``."""
    adam = VertexAdam(verts, learning_rate)
    for _ in range(n_steps):
        d, g = density_and_grad(verts)
        grad = mesh_opt_gradient(verts, faces, d, g, thresh, k_smooth, k_density, k_inflate)
        verts = adam.step(verts, grad)
    return verts
