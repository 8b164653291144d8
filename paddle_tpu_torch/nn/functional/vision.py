"""Sampling and warping functionals (counterpart of
``paddle_tpu/nn/functional/vision.py``): ``grid_sample``,
``affine_grid``, ``temporal_shift``.

``grid_sample`` gathers the four (or the nearest) neighbours as the JAX
package does: coordinates in (x, y) order, ``round`` half to even for
``'nearest'``, out-of-range neighbours read as zero (``'zeros'``) or
clamped to the edge (``'border'``).
"""
from __future__ import annotations

import torch

__all__ = ["grid_sample", "affine_grid", "temporal_shift"]


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x [N, C, H, W]`` at ``grid [N, Hg, Wg, 2]`` (normalized
    coordinates in [-1, 1]) -> ``[N, C, Hg, Wg]``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be bilinear/nearest, "
                         f"got {mode!r}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    n, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * (w - 1) / 2
        fy = (gy + 1) * (h - 1) / 2
    else:
        fx = ((gx + 1) * w - 1) / 2
        fy = ((gy + 1) * h - 1) / 2
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def take(ix, iy):
        v = x[bidx, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            v = torch.where(inside[..., None], v, v.new_zeros(()))
        return v                                  # [N, Hg, Wg, C]

    if mode == "nearest":
        out = take(torch.round(fx).long(), torch.round(fy).long())
        return out.movedim(-1, 1)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    x1, y1 = x0 + 1, y0 + 1
    wx = (fx - x0).to(x.dtype)[..., None]
    wy = (fy - y0).to(x.dtype)[..., None]
    out = (take(x0, y0) * (1 - wx) * (1 - wy) +
           take(x1, y0) * wx * (1 - wy) +
           take(x0, y1) * (1 - wx) * wy +
           take(x1, y1) * wx * wy)
    return out.movedim(-1, 1)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta [N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]``."""
    _, _, h, w = [int(s) for s in out_shape]
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")          # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)   # [H, W, 3]
    return torch.einsum("hwk,nck->nhwc", base.to(theta.dtype), theta)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """The TSM shift of ``x [N*T, C, H, W]``: the first ``shift_ratio``
    of the channels move one step back in time, the next as many one
    step forward, the rest stay."""
    nt, c, h, w = x.shape
    t = seg_num
    v = x.reshape(nt // t, t, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    pad = torch.zeros_like(v[:, :1])
    fwd = torch.cat([v[:, 1:, :c1], pad[:, :, :c1]], dim=1)
    back = torch.cat([pad[:, :, c1:c2], v[:, :-1, c1:c2]], dim=1)
    return torch.cat([fwd, back, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
