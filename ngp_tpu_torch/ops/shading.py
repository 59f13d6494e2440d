"""SDF render shading, the port of ``ngp_tpu/ops/shading.py``: the
reference's Disney-style BRDF and Quilez's soft-shadow update, elementwise
over rays.

``evaluate_shading`` reproduces ``src/testbed_sdf.cu:78-148`` term by term
(Burley's Disney BRDF: Schlick fresnel diffuse with retro-reflection, the
Hanrahan-Krueger subsurface approximation, GGX specular with Smith
masking, sheen, clearcoat). ``soft_shadow_visibility_update`` is one step
of the shadow ray's sphere trace (``advance_pos_kernel_sdf``,
``src/testbed_sdf.cu:196-206``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

PI = 3.14159265358979


@dataclass(frozen=True)
class BRDFParams:
    """Defaults from ``include/neural-graphics-primitives/sdf.h:62-73``."""

    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 0.5
    sheen: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    basecolor: tuple = (0.8, 0.8, 0.8)
    ambientcolor: tuple = (0.0, 0.0, 0.0)


def _schlick_fresnel(u):
    return torch.clamp(1.0 - u, 0.0, 1.0) ** 5


def _g1(ndoth, a: float):
    """Clearcoat distribution (``testbed_sdf.cu:56-61``)."""
    if a >= 1.0:
        return torch.full_like(ndoth, 1.0 / PI)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return (a2 - 1.0) / (PI * math.log(a2) * t)


def _g2(ndoth, a: float):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (PI * t * t)


def _smith_g_ggx(ndotv, alpha_g: float):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(a + b - a * b))


def _mix(a, b, t):
    return a + (b - a) * t


def evaluate_shading(base_color, ambient_color, light_color, L, V, N,
                     brdf: BRDFParams = BRDFParams()):
    """Disney-ish BRDF (``testbed_sdf.cu:78-148``) for ``base_color``,
    ``ambient_color`` and ``light_color`` (N, 3) (the ambient may be (3,)),
    unit light direction ``L`` (3,), view ``V`` and normal ``N`` (N, 3).
    ``specular_tint`` and ``sheen_tint`` are 0, as the reference's call site
    (``shade_kernel_sdf``, :354-356) passes them. Backfaces (N·L or N·V
    below 0) get the ambient term alone."""
    L = torch.as_tensor(L, dtype=N.dtype, device=N.device).expand_as(N)
    ndotl = torch.sum(N * L, dim=-1)
    ndotv = torch.sum(N * V, dim=-1)

    H = L + V
    H = H / torch.clamp_min(torch.linalg.norm(H, dim=-1, keepdim=True), 1e-9)
    ndoth = torch.sum(N * H, dim=-1)
    ldoth = torch.sum(L * H, dim=-1)

    FL = _schlick_fresnel(ndotl)
    FV = _schlick_fresnel(ndotv)
    amb = (torch.as_tensor(ambient_color, dtype=N.dtype, device=N.device).expand_as(base_color)
           * _mix(0.2, FV, brdf.metallic)[..., None] * base_color)

    cspec0 = _mix(torch.full_like(base_color, brdf.specular * 0.08), base_color, brdf.metallic)

    fd90 = 0.5 + 2.0 * ldoth * ldoth * brdf.roughness
    fd = _mix(1.0, fd90, FL) * _mix(1.0, fd90, FV)

    fss90 = ldoth * ldoth * brdf.roughness
    fss = _mix(1.0, fss90, FL) * _mix(1.0, fss90, FV)
    ss = 1.25 * (fss * (1.0 / torch.clamp_min(ndotl + ndotv, 1e-6) - 0.5) + 0.5)

    a = max(0.001, brdf.roughness ** 2)
    ds = _g2(ndoth, a)
    FH = _schlick_fresnel(ldoth)
    fs = _mix(cspec0, torch.ones_like(cspec0), FH[..., None])
    gs = _smith_g_ggx(ndotl, a) * _smith_g_ggx(ndotv, a)

    fsheen = FH[..., None] * brdf.sheen  # sheen_tint = 0: a white lobe

    dr = _g1(ndoth, _mix(0.1, 0.001, brdf.clearcoat_gloss))
    fr = _mix(0.04, 1.0, FH)
    gr = _smith_g_ggx(ndotl, 0.25) * _smith_g_ggx(ndotv, 0.25)
    ccs = 0.25 * brdf.clearcoat * gr * fr * dr

    diffuse = _mix(fd, ss, brdf.subsurface)[..., None] * base_color / PI
    brdf_val = ((diffuse + fsheen) * (1.0 - brdf.metallic)
                + (gs * ds)[..., None] * fs + ccs[..., None])
    lit = brdf_val * light_color * ndotl[..., None] + amb
    backface = (ndotl < 0.0) | (ndotv < 0.0)
    return torch.where(backface[..., None], amb, lit)


def soft_shadow_visibility_update(min_vis, prev_distance, total_distance, distance,
                                  k: float):
    """One sphere-trace step of Quilez's improved soft shadow: the
    occluder's closest approach from two consecutive sphere radii, the
    minimum penumbra ratio kept. Returns (min_vis', prev_distance',
    total_distance'); a step of distance ≤ 0 changes nothing."""
    y = distance * distance / (2.0 * torch.clamp_min(prev_distance, 1e-20))
    d = torch.sqrt(torch.clamp_min(distance * distance - y * y, 0.0))
    vis = k * d / torch.clamp_min(total_distance - y, 1e-20)
    upd = distance > 0.0
    return (torch.where(upd, torch.minimum(min_vis, vis), min_vis),
            torch.where(upd, distance, prev_distance),
            torch.where(upd, total_distance + distance, total_distance))
