"""Detection ops (counterpart of ``paddle_tpu/vision/ops.py``): boxes,
IoU, NMS, anchors, box coding, RoI align / pool, deformable convolution,
the YOLO box and loss.  Boxes are ``[N, 4]`` (x1, y1, x2, y2) unless
noted.

Each op runs on its inputs' device (numpy inputs go to the current
device, ``device.set_device``) and, where the JAX package's does,
differentiates through PyTorch's autograd: ``roi_align``, ``roi_pool``,
``deform_conv2d``, ``yolo_loss`` and the box math.  The JAX package
computes these ops outside Pallas, so they are plain PyTorch here too.

Semantics kept from the JAX package where they differ from Paddle's
kernels:

- ``sampling_ratio <= 0`` in ``roi_align`` is a fixed 2 x 2 grid a bin,
  not the adaptive ``ceil(roi / output)``;
- ``roi_pool`` is the max of a bilinear 2 x 2 grid a bin, not the max
  over the bin's pixels;
- ``nms`` returns the kept indices by descending score (ties in index
  order), as ``int32``;
- ``multiclass_nms`` and ``detection_map`` trim and score on the host;
  ``multiclass_nms`` returns ``[M, 6]`` rows (class, score, x1, y1, x2,
  y2), best first.

NMS visits boxes one at a time in score order, as the JAX package's
``lax.scan`` does, with no read back to the host inside the loop.
Bilinear sampling (RoI align / pool, deformable convolution) of 16-bit
inputs weighs and sums in f32 and rounds once, where the JAX package
rounds each weight and product to the input's dtype; f32 inputs take
the same operations as the JAX package's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import current_device
from ..nn import initializer as I
from ..nn.layer_base import Layer

__all__ = ["box_area", "box_iou", "iou_similarity", "box_clip",
           "box_coder", "nms", "multiclass_nms", "prior_box",
           "generate_anchors", "detection_map", "roi_align", "roi_pool",
           "deform_conv2d", "DeformConv2D", "yolo_box", "yolo_loss"]


def _t(x, device=None) -> torch.Tensor:
    """A tensor as it is, anything else as a tensor on ``device`` (the
    current device by default)."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=device or current_device())


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def box_area(boxes):
    b = _t(boxes)
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def box_iou(boxes1, boxes2):
    """Pairwise IoU ``[N, M]``."""
    a = _t(boxes1)
    b = _t(boxes2, a.device)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / union.clamp(min=1e-10)


iou_similarity = box_iou


def box_clip(boxes, im_shape):
    """Clip boxes into the image; ``im_shape`` is (h, w)."""
    h, w = float(im_shape[0]), float(im_shape[1])
    b = _t(boxes)
    return torch.stack([b[..., 0].clamp(0, w), b[..., 1].clamp(0, h),
                        b[..., 2].clamp(0, w), b[..., 3].clamp(0, h)],
                       dim=-1)


def box_coder(prior_boxes, target, code_type="encode_center_size",
              variance: Optional[Sequence[float]] = None):
    """Encode boxes against priors (``encode_center_size``), or decode
    deltas back into boxes (``decode_center_size``), with per-coordinate
    variances."""
    p = _t(prior_boxes)
    t = _t(target, p.device)
    var = torch.as_tensor(variance if variance is not None
                          else (1.0, 1.0, 1.0, 1.0), dtype=torch.float32,
                          device=p.device)
    pw = p[..., 2] - p[..., 0]
    ph = p[..., 3] - p[..., 1]
    pcx = p[..., 0] + 0.5 * pw
    pcy = p[..., 1] + 0.5 * ph
    if code_type.startswith("encode"):
        tw = t[..., 2] - t[..., 0]
        th = t[..., 3] - t[..., 1]
        tcx = t[..., 0] + 0.5 * tw
        tcy = t[..., 1] + 0.5 * th
        return torch.stack([
            (tcx - pcx) / pw / var[0], (tcy - pcy) / ph / var[1],
            torch.log((tw / pw).clamp(min=1e-10)) / var[2],
            torch.log((th / ph).clamp(min=1e-10)) / var[3]], dim=-1)
    cx = t[..., 0] * var[0] * pw + pcx
    cy = t[..., 1] * var[1] * ph + pcy
    w = torch.exp(t[..., 2] * var[2]) * pw
    h = torch.exp(t[..., 3] * var[3]) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def nms(boxes, scores, iou_threshold=0.5, score_threshold=None,
        top_k: Optional[int] = None):
    """Greedy NMS: the kept indices by descending score, ``int32``."""
    b = _t(boxes).float()
    s = _t(scores, b.device).float()
    keep = _nms_mask(b, s, float(iou_threshold),
                     -math.inf if score_threshold is None
                     else float(score_threshold))
    order = torch.argsort(-s, stable=True)
    kept = order[keep[order]]
    if top_k is not None:
        kept = kept[:top_k]
    return kept.to(torch.int32)


def _nms_mask(b, s, iou_thr, score_thr):
    """The keep mask, visiting boxes in score order (ties by index): a box
    is kept when its score passes and no kept box overlaps it above
    ``iou_thr``."""
    n = b.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=b.device)
    order = torch.argsort(-s, stable=True)
    bo = b[order]
    over = box_iou(bo, bo) > iou_thr          # [n, n] in score rank
    ok = s[order] > score_thr
    keep_r = torch.zeros(n, dtype=torch.bool, device=b.device)
    for i in range(n):
        keep_r[i] = ok[i] & ~(keep_r & over[i]).any()
    keep = torch.zeros_like(keep_r)
    keep[order] = keep_r
    return keep


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3):
    """Per-class NMS, then the best ``keep_top_k`` over all classes.
    ``bboxes`` ``[N, 4]``, ``scores`` ``[C, N]``; returns ``[M, 6]`` rows
    (class, score, x1, y1, x2, y2), best first, trimmed on the host."""
    device = bboxes.device if torch.is_tensor(bboxes) else current_device()
    b = _host(bboxes).astype(np.float32)
    sc = _host(scores).astype(np.float32)
    bt = torch.as_tensor(b, device=device)
    rows = []
    for c in range(sc.shape[0]):
        s = sc[c]
        cand = np.nonzero(s > score_threshold)[0]
        if len(cand) == 0:
            continue
        cand = cand[np.argsort(-s[cand])][:nms_top_k]
        kept = nms(bt[torch.as_tensor(cand, device=device)],
                   torch.as_tensor(s[cand], device=device),
                   iou_threshold=nms_threshold).cpu().numpy()
        for i in kept:
            gi = cand[int(i)]
            rows.append((float(c), float(s[gi]), *b[gi].tolist()))
    rows.sort(key=lambda r: -r[1])
    out = np.asarray(rows[:keep_top_k], np.float32).reshape(-1, 6)
    return torch.as_tensor(out, device=device)


def prior_box(feature_h, feature_w, image_h, image_w, min_sizes,
              max_sizes=(), aspect_ratios=(1.0,), flip=False,
              step=None, offset=0.5, clip=False):
    """SSD prior boxes over a feature grid: ``[H, W, A, 4]`` in
    normalized (x1, y1, x2, y2), on the current device."""
    ars = list(aspect_ratios)
    if flip:
        ars = ars + [1.0 / a for a in aspect_ratios if a != 1.0]
    step_x = step or image_w / feature_w
    step_y = step or image_h / feature_h
    whs = []
    for ms in min_sizes:
        for a in ars:
            whs.append((ms * np.sqrt(a), ms / np.sqrt(a)))
        for big in max_sizes:
            whs.append((np.sqrt(ms * big), np.sqrt(ms * big)))
    out = _anchor_grid(feature_h, feature_w, step_x, step_y, offset, whs)
    out = out / np.asarray([image_w, image_h, image_w, image_h], np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return torch.as_tensor(out.astype(np.float32), device=current_device())


def generate_anchors(feature_h, feature_w, stride, sizes=(32, 64, 128),
                     aspect_ratios=(0.5, 1.0, 2.0)):
    """RPN anchors: ``[H, W, A, 4]`` in image coordinates, on the current
    device."""
    whs = [(sz * np.sqrt(a), sz / np.sqrt(a))
           for sz in sizes for a in aspect_ratios]
    out = _anchor_grid(feature_h, feature_w, stride, stride, 0.5, whs)
    return torch.as_tensor(out.astype(np.float32), device=current_device())


def _anchor_grid(feature_h, feature_w, step_x, step_y, offset, whs):
    """Boxes of sizes ``whs`` centred on each cell: ``[H, W, A, 4]``."""
    whs = np.asarray(whs, np.float32)                       # [A, 2]
    cx = (np.arange(feature_w) + offset) * step_x
    cy = (np.arange(feature_h) + offset) * step_y
    cxg, cyg = np.meshgrid(cx, cy)                          # [H, W]
    centers = np.stack([cxg, cyg], -1)[:, :, None, :]       # [H, W, 1, 2]
    half = whs[None, None, :, :] / 2
    return np.concatenate([centers - half, centers + half], -1)


def _roi_grid(ba, ph, pw, sr, spatial_scale, off):
    """Sample centres of each RoI's bins in pixel coordinates: (fx, fy),
    each ``[R, ph*sr, pw*sr]``."""
    x1 = ba[:, 0] * spatial_scale - off
    y1 = ba[:, 1] * spatial_scale - off
    rw = (ba[:, 2] * spatial_scale - off - x1).clamp(min=1e-3)
    rh = (ba[:, 3] * spatial_scale - off - y1).clamp(min=1e-3)
    ys = (torch.arange(ph * sr, device=ba.device) + 0.5) / sr   # bin units
    xs = (torch.arange(pw * sr, device=ba.device) + 0.5) / sr
    gy = y1[:, None] + rh[:, None] * ys[None, :] / ph          # [R, ph*sr]
    gx = x1[:, None] + rw[:, None] * xs[None, :] / pw          # [R, pw*sr]
    r = ba.shape[0]
    return (gx[:, None, :].expand(r, ph * sr, pw * sr),
            gy[:, :, None].expand(r, ph * sr, pw * sr))


def _acc(dtype):
    """The dtype bilinear sampling weighs and sums in: f32 for 16-bit
    inputs."""
    return torch.promote_types(dtype, torch.float32)


def _roi_bilinear(xa, img_of, fx, fy):
    """Bilinear samples ``[R, hs, ws, C]`` (in ``_acc(xa.dtype)``) of
    feature map ``xa [N, C, H, W]`` at pixel coordinates ``fx, fy [R, hs,
    ws]`` of image ``img_of [R]``, gathering only the sampled points.  A
    coordinate in [-1, 0] (or [size-1, size]) takes the border pixel with
    full weight; one beyond that gives 0."""
    n, c, h, w = xa.shape
    valid = (fx >= -1.0) & (fx <= w) & (fy >= -1.0) & (fy <= h)
    fxc = fx.clamp(0.0, w - 1.0)
    fyc = fy.clamp(0.0, h - 1.0)
    x0 = torch.floor(fxc).long()
    y0 = torch.floor(fyc).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    wx = (fxc - x0).to(_acc(xa.dtype))[..., None]
    wy = (fyc - y0).to(_acc(xa.dtype))[..., None]
    rows = xa.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = img_of[:, None, None] * (h * w)

    def take(ix, iy):
        idx = (base + iy * w + ix).reshape(-1)
        return rows.index_select(0, idx).reshape(*ix.shape, c)

    out = (take(x0, y0) * (1 - wx) * (1 - wy) +
           take(x1, y0) * wx * (1 - wy) +
           take(x0, y1) * (1 - wx) * wy +
           take(x1, y1) * wx * wy)
    return torch.where(valid[..., None], out, 0.0)


def _img_of(boxes_num, n, r, device):
    """The image of each of the ``r`` RoIs: RoIs ``boxes_num[0]`` of image
    0 first, and so on; rows past the counts' sum take the last image (all
    on image 0 without ``boxes_num``)."""
    if boxes_num is None:
        return torch.zeros(r, dtype=torch.long, device=device)
    ends = torch.cumsum(_t(boxes_num, device).to(device).long(), 0)
    rows = torch.arange(r, device=device)
    return torch.searchsorted(ends, rows, right=True).clamp(max=n - 1)


def _resolve_sr(sampling_ratio):
    # Paddle's sampling_ratio <= 0 adapts the grid to each RoI; the JAX
    # package takes a fixed 2 x 2 grid a bin (static shapes), and so does
    # the port
    return 2 if sampling_ratio <= 0 else int(sampling_ratio)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _roi_samples(x, boxes, boxes_num, ph, pw, sr, spatial_scale, off):
    """``[R, ph, sr, pw, sr, C]`` bilinear samples of each RoI's bins."""
    x = _t(x)
    ba = _t(boxes, x.device).float()
    r = ba.shape[0]
    img_of = _img_of(boxes_num, x.shape[0], r, x.device)
    fx, fy = _roi_grid(ba, ph, pw, sr, spatial_scale, off)
    return _roi_bilinear(x, img_of, fx, fy).reshape(
        r, ph, sr, pw, sr, x.shape[1])


def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=2, aligned=True):
    """RoIAlign: each RoI's bins bilinear-sampled on an ``sr x sr`` grid
    and averaged into ``[R, C, ph, pw]``.  ``x`` ``[N, C, H, W]``;
    ``boxes`` ``[R, 4]`` in image coordinates, ``boxes_num [N]`` RoIs an
    image (all on image 0 without it).  Differentiable in ``x``."""
    ph, pw = (int(v) for v in _pair(output_size))
    sam = _roi_samples(x, boxes, boxes_num, ph, pw,
                       _resolve_sr(sampling_ratio), spatial_scale,
                       0.5 if aligned else 0.0)
    return sam.mean(dim=(2, 4)).permute(0, 3, 1, 2).to(
        _t(x).dtype).contiguous()


def roi_pool(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0):
    """RoIPool as the max of each bin's bilinear 2 x 2 samples (fixed
    shapes: the max over a bin's pixels is not kept for degenerate RoIs).
    Differentiable in ``x``."""
    ph, pw = (int(v) for v in _pair(output_size))
    sam = _roi_samples(x, boxes, boxes_num, ph, pw, 2, spatial_scale, 0.0)
    return sam.amax(dim=(2, 4)).permute(0, 3, 1, 2).to(
        _t(x).dtype).contiguous()


def detection_map(detections, gt_boxes, gt_labels, overlap_threshold=0.5,
                  ap_version="integral"):
    """Mean average precision of a detection set, on the host.
    ``detections``: a ``[M, 6]`` array an image (``multiclass_nms`` rows);
    ``gt_boxes`` / ``gt_labels``: ``[G, 4]`` / ``[G]`` an image.
    ``ap_version``: ``'integral'`` (VOC2010 area) or ``'11point'``."""
    per_class, npos = {}, {}
    for det, gtb, gtl in zip(detections, gt_boxes, gt_labels):
        det = _host(det).astype(np.float32).reshape(-1, 6)
        gtb = _host(gtb).astype(np.float32).reshape(-1, 4)
        gtl = _host(gtl).reshape(-1).astype(np.int64)
        for c in gtl:
            npos[int(c)] = npos.get(int(c), 0) + 1
        matched = np.zeros(len(gtb), bool)
        for row in det[np.argsort(-det[:, 1])]:
            c, score = int(row[0]), float(row[1])
            cand = np.nonzero(gtl == c)[0]
            best = -1
            if len(cand):
                ious = box_iou(torch.from_numpy(row[None, 2:6].copy()),
                               torch.from_numpy(gtb[cand])).numpy()[0]
                j = int(np.argmax(ious))
                if ious[j] >= overlap_threshold and not matched[cand[j]]:
                    best = cand[j]
            if best >= 0:
                matched[best] = True
            per_class.setdefault(c, []).append((score, best >= 0))
    aps = []
    for c, rows in per_class.items():
        rows.sort(key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in rows])
        fps = np.cumsum([not r[1] for r in rows])
        recall = tps / max(npos.get(c, 0), 1)
        precision = tps / np.maximum(tps + fps, 1)
        if ap_version == "11point":
            ap = float(np.mean([
                precision[recall >= t].max() if (recall >= t).any()
                else 0.0 for t in np.linspace(0, 1, 11)]))
        else:  # the area under the interpolated precision-recall curve
            prec = np.maximum.accumulate(precision[::-1])[::-1]
            rec = np.concatenate([[0.0], recall])
            ap = float(np.sum((rec[1:] - rec[:-1]) * prec))
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def _bilinear_zero(img, ys, xs):
    """Samples ``[G, C, L]`` (in ``_acc(img.dtype)``) of ``img [G, C, H,
    W]`` at float coordinates ``ys, xs [G, L]``, zero outside."""
    g, c, h, w = img.shape
    acc = _acc(img.dtype)
    flat = img.reshape(g, c, h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0).to(acc)[:, None, :]
    wx = (xs - x0).to(acc)[:, None, :]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        v = flat.gather(2, idx[:, None, :].expand(g, c, idx.shape[1]))
        return v * inside.to(acc)[:, None, :]

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution, v1, or v2 with ``mask``.  ``x [N, Cin, H,
    W]``, ``offset [N, 2*dg*kh*kw, Ho, Wo]`` in (dy, dx) pairs, ``mask
    [N, dg*kh*kw, Ho, Wo]``, ``weight [Cout, Cin/groups, kh, kw]``."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg, g = deformable_groups, groups
    N, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = x.device
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    # each output position's kernel taps, before the offsets
    iy = (torch.arange(Ho, device=dev) * sh - ph)[:, None]
    ix = (torch.arange(Wo, device=dev) * sw - pw)[None, :]
    ty = torch.arange(kh, device=dev).repeat_interleave(kw) * dh
    tx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    ys = (iy[None] + ty[:, None, None])[None, None] + off[:, :, :, 0]
    xs = (ix[None] + tx[:, None, None])[None, None] + off[:, :, :, 1]
    cols = _bilinear_zero(x.reshape(N * dg, Cin // dg, H, W),
                          ys.reshape(N * dg, K * Ho * Wo),
                          xs.reshape(N * dg, K * Ho * Wo))
    cols = cols.reshape(N, dg, Cin // dg, K, Ho, Wo)
    if mask is not None:
        cols = cols * mask.reshape(N, dg, 1, K, Ho, Wo).to(cols.dtype)
    cols = cols.to(x.dtype).reshape(N, g, Cin // g, K, Ho, Wo)
    wgt = weight.reshape(g, Cout // g, Cin // g, K)
    out = torch.einsum("ngckhw,gock->ngohw", cols, wgt).reshape(
        N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


class DeformConv2D(Layer):
    """Layer over ``deform_conv2d``: weight ``[Cout, Cin/groups, kh, kw]``
    uniform in +-sqrt(1 / fan_in), bias by ``bias_attr``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._args = (stride, padding, dilation, deformable_groups, groups)
        bound = math.sqrt(1.0 / (in_channels // groups * kh * kw))
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw], attr=weight_attr,
            default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self._args
        return deform_conv2d(x, offset, self.weight, self.bias, stride=s,
                             padding=p, dilation=d, deformable_groups=dg,
                             groups=g, mask=mask)


def _yolo_centres(p, sxy, h, w):
    """Box centres (normalized) of each cell's predictions ``p [N, A,
    5+C, H, W]``."""
    gx = torch.arange(w, dtype=torch.float32, device=p.device)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=p.device)[:, None]
    bx = (torch.sigmoid(p[:, :, 0]) * sxy - 0.5 * (sxy - 1.0) + gx) / w
    by = (torch.sigmoid(p[:, :, 1]) * sxy - 0.5 * (sxy - 1.0) + gy) / h
    return bx, by


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0, name=None):
    """Decode a YOLOv3 head ``x [N, an*(5+C), H, W]`` into boxes ``[N,
    an*H*W, 4]`` (x1, y1, x2, y2 in image pixels; ``img_size [N, 2]`` is
    (h, w)) and scores ``[N, an*H*W, C]``; predictions whose confidence
    is under ``conf_thresh`` are zeroed."""
    an = len(anchors) // 2
    anc = torch.as_tensor(np.asarray(anchors, np.float32).reshape(an, 2),
                          device=x.device)
    C = class_num
    N, _, H, W = x.shape
    in_h, in_w = H * downsample_ratio, W * downsample_ratio
    p = x.reshape(N, an, 5 + C, H, W)
    bx, by = _yolo_centres(p, float(scale_x_y), H, W)
    bw = torch.exp(p[:, :, 2]) * anc[None, :, 0, None, None] / in_w
    bh = torch.exp(p[:, :, 3]) * anc[None, :, 1, None, None] / in_h
    conf = torch.sigmoid(p[:, :, 4])
    keep = (conf >= conf_thresh).to(x.dtype)
    scores = torch.sigmoid(p[:, :, 5:]) * (conf * keep)[:, :, None]
    imsz = _t(img_size, x.device)
    imh = imsz[:, 0].float()[:, None, None, None]
    imw = imsz[:, 1].float()[:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        x1 = torch.minimum(x1.clamp(min=0), imw - 1)
        y1 = torch.minimum(y1.clamp(min=0), imh - 1)
        x2 = torch.minimum(x2.clamp(min=0), imw - 1)
        y2 = torch.minimum(y2.clamp(min=0), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    return (boxes.reshape(N, -1, 4),
            scores.movedim(2, -1).reshape(N, -1, C))


def _bce(logit, label):
    return F.softplus(logit) - label * logit


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3 loss of one head, ``[N]``.  ``x [N, am*(5+C), H, W]``;
    ``gt_box [N, B, 4]`` (cx, cy, w, h normalized to the image, zero
    rows for padding); ``gt_label [N, B]``.  Each gt goes to its best
    anchor over all anchors by the IoU of widths and heights, and to this
    head's cell when that anchor is in ``anchor_mask``; x / y take a
    sigmoid cross-entropy, w / h an L1 term, both weighted by
    (2 - w * h); objectness a cross-entropy whose negatives skip
    predictions that overlap a gt above ``ignore_thresh``; the classes a
    cross-entropy (labels smoothed by 1 / class_num).  ``gt_score``
    weights a gt's positive terms."""
    all_anc = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask_idx = list(anchor_mask)
    am = len(mask_idx)
    C = class_num
    smooth = (1.0 / max(C, 1)) if (use_label_smooth and C > 1) else 0.0
    dev = x.device
    gtb = _t(gt_box, dev).float()
    gtl = _t(gt_label, dev)
    N, _, H, W = x.shape
    B = gtb.shape[1]
    in_h, in_w = float(H * downsample_ratio), float(W * downsample_ratio)
    p = x.reshape(N, am, 5 + C, H, W)
    anc = torch.as_tensor(all_anc, device=dev)               # [A, 2] pixels
    head = anc[mask_idx]                                      # [am, 2]

    # each gt's best anchor over all anchors (centred wh IoU)
    gw = gtb[:, :, 2] * in_w
    gh = gtb[:, :, 3] * in_h
    inter = torch.minimum(gw[..., None], anc[None, None, :, 0]) * \
        torch.minimum(gh[..., None], anc[None, None, :, 1])
    union = gw[..., None] * gh[..., None] + \
        anc[None, None, :, 0] * anc[None, None, :, 1] - inter
    best = torch.argmax(inter / union.clamp(min=1e-9), dim=2)  # [N, B]
    valid = (gtb[:, :, 2] > 0) & (gtb[:, :, 3] > 0)
    gi = (gtb[:, :, 0] * W).long().clamp(0, W - 1)
    gj = (gtb[:, :, 1] * H).long().clamp(0, H - 1)
    cell = gj * W + gi                                        # [N, B]

    # targets summed onto each anchor's cells with binary weights, then
    # averaged by the cell's gt count; gt_score summed apart, so a
    # fractional score weights the positive terms
    gts = torch.ones(N, B, device=dev) if gt_score is None \
        else _t(gt_score, dev).float()
    tx = gtb[:, :, 0] * W - torch.floor(gtb[:, :, 0] * W)
    ty = gtb[:, :, 1] * H - torch.floor(gtb[:, :, 1] * H)
    box_w = 2.0 - gtb[:, :, 2] * gtb[:, :, 3]
    cls1 = (gtl[..., None] == torch.arange(C, device=dev)).float() * \
        (1.0 - smooth) + smooth / max(C, 1)
    tgt, found, score_sum = [], [], []
    for k, a_id in enumerate(mask_idx):
        sel = (valid & (best == a_id)).float()
        tw = torch.log((gtb[:, :, 2] * in_w / head[k, 0]).clamp(min=1e-9))
        th = torch.log((gtb[:, :, 3] * in_h / head[k, 1]).clamp(min=1e-9))
        rows = torch.cat([torch.stack([tx, ty, tw, th, torch.ones_like(tx),
                                       box_w], dim=-1), cls1], dim=-1)
        src = (rows * sel[..., None]).transpose(1, 2)         # [N, 6+C, B]
        idx = cell[:, None, :].expand(N, 6 + C, B)
        tgt.append(torch.zeros(N, 6 + C, H * W, device=dev)
                   .scatter_add(2, idx, src))
        found.append(torch.zeros(N, H * W, device=dev)
                     .scatter_add(1, cell, sel))
        score_sum.append(torch.zeros(N, H * W, device=dev)
                         .scatter_add(1, cell, sel * gts))
    tgt = torch.stack(tgt, 1).reshape(N, am, 6 + C, H, W)
    found = torch.stack(found, 1).reshape(N, am, H, W)
    score_sum = torch.stack(score_sum, 1).reshape(N, am, H, W)
    obj_mask = (found > 0).float()
    norm = found.clamp(min=1e-9)
    tgt = tgt / norm[:, :, None]
    score_map = score_sum / norm

    # the ignore mask: predictions overlapping any gt above ignore_thresh
    bx, by = _yolo_centres(p, float(scale_x_y), H, W)
    bw = torch.exp(p[:, :, 2].clamp(-10, 10)) * \
        head[None, :, 0, None, None] / in_w
    bh = torch.exp(p[:, :, 3].clamp(-10, 10)) * \
        head[None, :, 1, None, None] / in_h
    px1, px2 = bx - bw / 2, bx + bw / 2
    py1, py2 = by - bh / 2, by + bh / 2
    qx1 = gtb[:, :, 0] - gtb[:, :, 2] / 2
    qx2 = gtb[:, :, 0] + gtb[:, :, 2] / 2
    qy1 = gtb[:, :, 1] - gtb[:, :, 3] / 2
    qy2 = gtb[:, :, 1] + gtb[:, :, 3] / 2

    def gt5(v):
        return v[:, None, None, None, :]

    ix = (torch.minimum(px2[..., None], gt5(qx2)) -
          torch.maximum(px1[..., None], gt5(qx1))).clamp(min=0)
    iy = (torch.minimum(py2[..., None], gt5(qy2)) -
          torch.maximum(py1[..., None], gt5(qy1))).clamp(min=0)
    inter_p = ix * iy
    area_p = (px2 - px1) * (py2 - py1)
    area_g = gt5((qx2 - qx1) * (qy2 - qy1))
    iou = inter_p / (area_p[..., None] + area_g - inter_p).clamp(min=1e-9)
    iou = torch.where(gt5(valid), iou, 0.0)
    ignore = (iou.amax(dim=4) > ignore_thresh).float()
    noobj_mask = (1.0 - obj_mask) * (1.0 - ignore)

    pos_w = obj_mask * score_map
    box_wt = tgt[:, :, 5]
    loss_xy = box_wt * pos_w * (_bce(p[:, :, 0], tgt[:, :, 0]) +
                                _bce(p[:, :, 1], tgt[:, :, 1]))
    loss_wh = box_wt * pos_w * ((p[:, :, 2] - tgt[:, :, 2]).abs() +
                                (p[:, :, 3] - tgt[:, :, 3]).abs())
    loss_obj = pos_w * _bce(p[:, :, 4], torch.ones_like(obj_mask)) + \
        noobj_mask * _bce(p[:, :, 4], torch.zeros_like(obj_mask))
    cls_t = tgt[:, :, 6:].movedim(2, -1)                     # [N, am, H, W, C]
    cls_p = p[:, :, 5:].movedim(2, -1)
    loss_cls = pos_w[..., None] * _bce(cls_p, cls_t)
    return (loss_xy.sum(dim=(1, 2, 3)) + loss_wh.sum(dim=(1, 2, 3)) +
            loss_obj.sum(dim=(1, 2, 3)) + loss_cls.sum(dim=(1, 2, 3, 4)))
