"""Image quality metrics for held-out evaluation: the port's copy of
``ngp_tpu/utils/metrics.py`` (numpy on the host; eval images are small
beside the render that makes them).

Images are compared in clipped sRGB space, as the reference's
``scripts/run.py`` does over ``--test_transforms`` renders: PSNR =
-10·log10(MSE), SSIM with the standard Gaussian window (11 taps, σ 1.5),
and an independent implementation of the published LDR-FLIP algorithm in
``flip()``.
"""

from __future__ import annotations

import math

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.mean((a - b) ** 2))


def psnr_from_mse(m: float) -> float:
    return -10.0 * math.log10(max(m, 1e-12))


def psnr(a, b) -> float:
    return psnr_from_mse(mse(a, b))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(r ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float64)


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2D correlation with 'valid' boundary, per channel."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(k)
    out = sliding_window_view(img, n, axis=0) @ k  # (H-n+1, W, C)
    out = sliding_window_view(out, n, axis=1) @ k  # (H-n+1, W-n+1, C)
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004): 11×11 Gaussian window σ=1.5,
    K1=0.01, K2=0.03 — the convention the reference's eval uses."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu_a = _filter2_sep(a, k)
    mu_b = _filter2_sep(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2_sep(a * a, k) - mu_aa
    s_bb = _filter2_sep(b * b, k) - mu_bb
    s_ab = _filter2_sep(a * b, k) - mu_ab
    num = (2 * mu_ab + C1) * (2 * s_ab + C2)
    den = (mu_aa + mu_bb + C1) * (s_aa + s_bb + C2)
    return float(np.mean(num / den))


# ----------------------------------------------------------------------
# LDR-FLIP (Andersson et al. 2020, "FLIP: A Difference Evaluator for
# Alternating Images"). Independent implementation of the published
# algorithm: color pipeline (sRGB → YCxCz → CSF-filtered → Hunt-adjusted
# L*a*b* → HyAB) combined with a feature (edge/point) difference.

def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


_M_RGB2XYZ = np.array(
    [
        [0.41238656, 0.35759149, 0.18045049],
        [0.21263682, 0.71518298, 0.0721802],
        [0.01933062, 0.11919716, 0.95037259],
    ]
)
_D65 = np.array([0.950428545, 1.0, 1.088900371])


def _linrgb_to_ycxcz(rgb):
    xyz = rgb @ _M_RGB2XYZ.T
    xyz_n = xyz / _D65
    y = 116.0 * xyz_n[..., 1] - 16.0
    cx = 500.0 * (xyz_n[..., 0] - xyz_n[..., 1])
    cz = 200.0 * (xyz_n[..., 1] - xyz_n[..., 2])
    return np.stack([y, cx, cz], -1)


def _ycxcz_to_linrgb(ycxcz):
    y = (ycxcz[..., 0] + 16.0) / 116.0
    cx = ycxcz[..., 1] / 500.0
    cz = ycxcz[..., 2] / 200.0
    xyz = np.stack([y + cx, y, y - cz], -1) * _D65
    return xyz @ np.linalg.inv(_M_RGB2XYZ).T


def _linrgb_to_lab(rgb):
    xyz = rgb @ _M_RGB2XYZ.T
    t = xyz / _D65
    delta = 6.0 / 29.0
    f = np.where(t > delta ** 3, np.cbrt(np.maximum(t, 1e-12)), t / (3 * delta ** 2) + 4.0 / 29.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], -1)


def _hunt(lab):
    L = lab[..., 0]
    return np.stack([L, 0.01 * L * lab[..., 1], 0.01 * L * lab[..., 2]], -1)


def _gauss2d(sigma, radius, ppd):
    x = np.arange(-radius, radius + 1) / ppd
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _sep_filter(img, k):
    """Same-size separable filtering with edge replication."""
    r = (len(k) - 1) // 2
    pad = np.pad(img, ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2), mode="edge")
    from numpy.lib.stride_tricks import sliding_window_view

    out = sliding_window_view(pad, len(k), axis=0) @ k
    out = sliding_window_view(out, len(k), axis=1) @ k
    return out


def flip(reference: np.ndarray, test: np.ndarray, ppd: float = 67.0) -> float:
    """Mean LDR-FLIP error in [0, 1] between two sRGB images in [0,1]."""
    ref = _srgb_to_linear(np.clip(np.asarray(reference, np.float64), 0, 1))[..., :3]
    tst = _srgb_to_linear(np.clip(np.asarray(test, np.float64), 0, 1))[..., :3]

    yref = _linrgb_to_ycxcz(ref)
    ytst = _linrgb_to_ycxcz(tst)

    # CSF spatial filtering per channel (gaussian approximations of the
    # achromatic / red-green / blue-yellow CSFs, per the FLIP paper's
    # sigma parameters).
    sigmas = [0.0047, 0.0053, 0.04]  # deg², a1-dominant lobes
    filtered_ref = np.empty_like(yref)
    filtered_tst = np.empty_like(ytst)
    for c, s2 in enumerate(sigmas):
        sigma = math.sqrt(s2)
        radius = max(int(math.ceil(3.0 * sigma * ppd)), 1)
        k = _gauss2d(sigma, radius, ppd)
        filtered_ref[..., c] = _sep_filter(yref[..., c : c + 1], k)[..., 0]
        filtered_tst[..., c] = _sep_filter(ytst[..., c : c + 1], k)[..., 0]

    ref_rgb = np.clip(_ycxcz_to_linrgb(filtered_ref), 0, 1)
    tst_rgb = np.clip(_ycxcz_to_linrgb(filtered_tst), 0, 1)

    lab_ref = _hunt(_linrgb_to_lab(ref_rgb))
    lab_tst = _hunt(_linrgb_to_lab(tst_rgb))
    # HyAB distance
    de = np.abs(lab_ref[..., 0] - lab_tst[..., 0]) + np.sqrt(
        (lab_ref[..., 1] - lab_tst[..., 1]) ** 2
        + (lab_ref[..., 2] - lab_tst[..., 2]) ** 2
    )

    # normalize via the paper's exponent remap
    cmax = np.abs(
        _hunt(_linrgb_to_lab(np.array([0.0, 1.0, 0.0])))
        - _hunt(_linrgb_to_lab(np.array([0.0, 0.0, 1.0])))
    )
    cmax = cmax[0] + math.hypot(cmax[1], cmax[2])
    pc, pt, qc = 0.4, 0.95, 0.7
    de_n = de / cmax
    color_err = np.where(
        de_n < pc * cmax / cmax,
        (pt / pc) * de_n,
        pt + ((de_n - pc) / (1 - pc)) * (1 - pt),
    )
    color_err = np.clip(color_err, 0, 1) ** qc

    # feature difference on luminance (edges and points via gaussian
    # derivative filters at sigma = 0.5·w·ppd)
    yr = (yref[..., 0] + 16.0) / 116.0
    yt = (ytst[..., 0] + 16.0) / 116.0
    w = 0.082
    sigma_f = 0.5 * w * ppd
    radius = int(math.ceil(3 * sigma_f))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2 * sigma_f ** 2))
    g /= g.sum()
    dg = -x / (sigma_f ** 2) * g
    ddg = (x ** 2 / sigma_f ** 4 - 1.0 / sigma_f ** 2) * g

    def filt_xy(img, kx, ky):
        r = radius
        pad = np.pad(img, r, mode="edge")
        from numpy.lib.stride_tricks import sliding_window_view

        out = sliding_window_view(pad, len(kx), axis=1) @ kx
        out = sliding_window_view(out, len(ky), axis=0) @ ky
        return out

    def features(yimg):
        ex = filt_xy(yimg, dg, g)
        ey = filt_xy(yimg, g, dg)
        px = filt_xy(yimg, ddg, g)
        py = filt_xy(yimg, g, ddg)
        return np.hypot(ex, ey), np.hypot(px, py)

    er, pr = features(yr)
    et, pt_ = features(yt)
    qf = 0.5
    feat_err = np.clip(
        np.maximum(np.abs(er - et), np.abs(pr - pt_)) * (1.0 / math.sqrt(2)), 0, 1
    ) ** qf

    err = color_err ** (1.0 - feat_err)
    return float(np.mean(err))
