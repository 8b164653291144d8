"""The port's detection ops (``paddle_tpu_torch.vision.ops``) against the
JAX package's (``paddle_tpu.vision.ops``), on the CPU, on seeded numpy
inputs at small sizes.

The JAX references that trace are staged under ``jax.jit`` (inputs as
arguments, the backward of ``sum(out * cot)`` inside); ``nms``,
``multiclass_nms``, ``prior_box``, ``generate_anchors`` and
``detection_map`` run eagerly (host code or data-dependent shapes).

Tolerances (f32 on both sides):
- box math, box coding, ``yolo_box``: within 1e-6 relative, or 1e-6 of
  the output's largest magnitude near 0 (BOX_TOL: elementwise f32, the
  same operations in the same order; ``exp`` / ``log`` / ``sigmoid`` may
  differ by an ulp);
- ``roi_align``, ``roi_pool``, ``deform_conv2d``, ``yolo_loss`` and
  their gradients: within 1e-5 of each output's largest magnitude
  (NET_TOL: f32 sums in another order);
- ``nms`` kept indices, ``multiclass_nms`` rows, ``prior_box``,
  ``generate_anchors`` and ``detection_map``: equal.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as tp
from paddle_tpu_torch.vision import ops as tops

BOX_TOL = 1e-6
NET_TOL = 1e-5

# YOLOv3's nine anchors (Redmon and Farhadi 2018) and its three heads' masks
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU; the JAX references compile with XLA's
    optimization passes (without them JAX's ``roi_pool`` gradient comes
    out NaN at some of the max's ties) and without the persistent cache
    (none is reused)."""
    tp.set_device("cpu")
    tp.seed(21)
    was = jax.config.values["jax_enable_compilation_cache"]
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", was)


def _boxes(rng, n, side=40.0):
    """``n`` boxes (x1, y1, x2, y2) around a few cluster centres, so that
    many overlap."""
    centres = rng.uniform(0, side, (4, 2))
    c = centres[rng.randint(0, 4, n)] + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(4, 16, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def _within(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err} vs {tol} x {scale}"


def _close(got, want, tol=BOX_TOL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


def _jax_run(op, arrays, diff=(), cot=None, **kw):
    """``op`` of the JAX package over Tensors of ``arrays`` (those at
    ``diff`` want gradients), under ``jax.jit``: its outputs and the
    gradients of ``sum(outputs[0] * cot)``."""
    def run(*arrs):
        ts = [jp.Tensor(a, stop_gradient=i not in diff)
              for i, a in enumerate(arrs)]
        out = op(*ts, **kw)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        if diff:
            (outs[0] * jp.Tensor(cot)).sum().backward()
        return [o.data for o in outs], [ts[i].grad.data for i in diff]

    outs, grads = jax.jit(run)(*arrays)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_run(op, arrays, diff=(), cot=None, **kw):
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    out = op(*ts, **kw)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if diff:
        (outs[0] * torch.from_numpy(cot)).sum().backward()
    return ([o.detach().numpy() for o in outs],
            [ts[i].grad.numpy() for i in diff])


def test_every_public_name_of_the_jax_module_is_ported():
    names = {n for n in dir(jops) if not n.startswith("_")
             and callable(getattr(jops, n))
             and getattr(getattr(jops, n), "__module__", "") == jops.__name__}
    names.add("iou_similarity")
    assert len(names) == 16
    assert names <= set(tops.__all__) and set(tops.__all__) == names
    assert tops.iou_similarity is tops.box_iou


@pytest.mark.parametrize("name", ["box_area", "box_iou", "box_clip"])
def test_box_math_matches_jax(name):
    rng = np.random.RandomState(1)
    a = _boxes(rng, 7)
    a[2, 2] = a[2, 0] - 1.0   # a box of negative width: its area clips to 0
    b = _boxes(rng, 5)
    if name == "box_area":
        args, kw = (a,), {}
    elif name == "box_iou":
        args, kw = (a, b), {}
    else:
        args, kw = (a,), {"im_shape": (30, 25)}
    want, _ = _jax_run(getattr(jops, name), args, **kw)
    got, _ = _port_run(getattr(tops, name), args, **kw)
    _close(got[0], want[0], what=name)


@pytest.mark.parametrize("code_type", ["encode_center_size",
                                       "decode_center_size"])
def test_box_coder_matches_jax(code_type):
    """Priors ``[P, 1, 4]`` against targets ``[P, M, 4]`` (broadcast), with
    SSD's variances."""
    rng = np.random.RandomState(2)
    priors = _boxes(rng, 6)[:, None, :]
    if code_type.startswith("encode"):
        target = _boxes(rng, 6 * 3).reshape(6, 3, 4)
    else:
        target = rng.normal(0, 0.5, (6, 3, 4)).astype(np.float32)
    kw = {"code_type": code_type, "variance": (0.1, 0.1, 0.2, 0.2)}
    want, _ = _jax_run(jops.box_coder, (priors, target), **kw)
    got, _ = _port_run(tops.box_coder, (priors, target), **kw)
    _close(got[0], want[0], what=code_type)


def test_box_coder_round_trip():
    priors = torch.tensor([[0., 0., 4., 4.], [2., 2., 6., 8.]])
    gt = torch.tensor([[1., 1., 3., 5.], [0., 0., 8., 8.]])
    enc = tops.box_coder(priors, gt, "encode_center_size")
    dec = tops.box_coder(priors, enc, "decode_center_size")
    torch.testing.assert_close(dec, gt, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("iou,score_thr,top_k", [(0.5, None, None),
                                                 (0.3, 0.35, 6),
                                                 (0.7, None, 3)])
def test_nms_matches_jax(iou, score_thr, top_k):
    """Scores rounded to one decimal, so equal scores are common: the
    visit order among them is the index order in both."""
    rng = np.random.RandomState(3)
    b = _boxes(rng, 40)
    s = np.round(rng.uniform(0, 1, 40), 1).astype(np.float32)
    want = np.asarray(jops.nms(b, s, iou_threshold=iou,
                               score_threshold=score_thr, top_k=top_k).data)
    got = tops.nms(b, s, iou_threshold=iou, score_threshold=score_thr,
                   top_k=top_k)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(want) > 1


def test_nms_equal_scores_keep_the_lower_index():
    b = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30],
                  [1, 1, 11, 11]], np.float32)
    s = np.array([0.5, 0.5, 0.5, 0.9], np.float32)
    got = tops.nms(b, s, iou_threshold=0.5).tolist()
    assert got == [3, 2] == np.asarray(jops.nms(b, s, 0.5).data).tolist()
    assert tops.nms(np.zeros((0, 4), np.float32),
                    np.zeros(0, np.float32)).numel() == 0


def test_multiclass_nms_matches_jax():
    rng = np.random.RandomState(4)
    b = _boxes(rng, 60)
    sc = rng.uniform(0, 1, (5, 60)).astype(np.float32) ** 2
    kw = dict(score_threshold=0.2, nms_top_k=20, keep_top_k=25,
              nms_threshold=0.4)
    want = np.asarray(jops.multiclass_nms(b, sc, **kw).data)
    got = tops.multiclass_nms(torch.from_numpy(b), torch.from_numpy(sc), **kw)
    assert want.shape == (25, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    # a class with no candidate above the threshold adds no row
    empty = tops.multiclass_nms(b, np.zeros((2, 60), np.float32))
    assert tuple(empty.shape) == (0, 6)


@pytest.mark.parametrize("kw", [
    dict(min_sizes=(30.0,), max_sizes=(60.0,), aspect_ratios=(1.0, 2.0),
         flip=True, clip=True),
    dict(min_sizes=(21.0, 45.0), aspect_ratios=(2.0, 3.0), flip=True,
         step=8.0, offset=0.4),
], ids=["clip", "step"])
def test_prior_box_matches_jax(kw):
    want = np.asarray(jops.prior_box(3, 5, 100, 150, **kw).data)
    got = tops.prior_box(3, 5, 100, 150, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_anchors_matches_jax():
    want = np.asarray(jops.generate_anchors(4, 6, 16, sizes=(32, 64),
                                            aspect_ratios=(0.5, 1.0)).data)
    got = tops.generate_anchors(4, 6, 16, sizes=(32, 64),
                                aspect_ratios=(0.5, 1.0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == (4, 6, 4, 4)


def _roi_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (2, 3, 12, 10)).astype(np.float32)
    # some boxes reach past the map: the border rule and the zero samples
    boxes = _boxes(rng, 5, side=22.0) - 2.0
    cot = rng.normal(0, 1, (5, 3, 3, 3)).astype(np.float32)
    return x, boxes, cot


@pytest.mark.parametrize("kw", [
    dict(boxes_num=np.array([3, 2]), spatial_scale=0.5, sampling_ratio=2),
    dict(spatial_scale=0.5, sampling_ratio=0, aligned=False),
    dict(boxes_num=np.array([1, 4]), spatial_scale=0.4, sampling_ratio=3),
], ids=["boxes_num", "adaptive_is_2x2", "sr3"])
def test_roi_align_and_gradients_match_jax(kw):
    x, boxes, cot = _roi_inputs(5)
    want, jg = _jax_run(jops.roi_align, (x, boxes), (0, 1), cot,
                        output_size=3, **kw)
    got, tg = _port_run(tops.roi_align, (x, boxes), (0, 1), cot,
                        output_size=3, **kw)
    _within(got[0], want[0], NET_TOL, "roi_align")
    _within(tg[0], jg[0], NET_TOL, "d x")
    _within(tg[1], jg[1], NET_TOL, "d boxes")


@pytest.mark.parametrize("boxes_num", [None, np.array([2, 3])])
def test_roi_pool_and_gradients_match_jax(boxes_num):
    x, boxes, cot = _roi_inputs(6)
    kw = dict(boxes_num=boxes_num, output_size=3, spatial_scale=0.5)
    want, jg = _jax_run(jops.roi_pool, (x, boxes), (0,), cot, **kw)
    got, tg = _port_run(tops.roi_pool, (x, boxes), (0,), cot, **kw)
    _within(got[0], want[0], NET_TOL, "roi_pool")
    _within(tg[0], jg[0], NET_TOL, "d x")


def test_roi_align_constant_map_and_the_border():
    """Every bin of a constant map is the constant, edge RoIs included
    (samples in [-1, 0] take the border pixel)."""
    x = torch.full((1, 2, 16, 16), 3.5)
    boxes = torch.tensor([[0., 0., 1., 1.], [4., 4., 12., 15.]])
    torch.testing.assert_close(tops.roi_align(x, boxes, output_size=2),
                               torch.full((2, 2, 2, 2), 3.5))


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_matches_jax(ap_version):
    rng = np.random.RandomState(7)
    dets, gtb, gtl = [], [], []
    for _ in range(3):
        g = _boxes(rng, 6)
        lab = rng.randint(0, 3, 6)
        noisy = np.concatenate([g + rng.normal(0, 1.5, g.shape),
                                _boxes(rng, 4)]).astype(np.float32)
        d = np.concatenate([
            np.concatenate([lab, rng.randint(0, 3, 4)])[:, None],
            rng.uniform(0, 1, (10, 1)), noisy], 1).astype(np.float32)
        dets.append(d)
        gtb.append(g)
        gtl.append(lab.astype(np.int64))
    want = jops.detection_map(dets, gtb, gtl, overlap_threshold=0.5,
                              ap_version=ap_version)
    got = tops.detection_map([torch.from_numpy(d) for d in dets], gtb, gtl,
                             overlap_threshold=0.5, ap_version=ap_version)
    assert 0.0 < got < 1.0 and got == want


def _deform_inputs(seed, groups, dg, with_mask):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (2, 4, 6, 7)).astype(np.float32)
    w = (rng.normal(0, 1, (6, 4 // groups, 3, 3)) * 0.3).astype(np.float32)
    off = (rng.normal(0, 1.5, (2, 2 * dg * 9, 6, 7))).astype(np.float32)
    arrays = [x, off, w]
    if with_mask:
        arrays.append(rng.uniform(0, 1, (2, dg * 9, 6, 7)).astype(np.float32))
    arrays.append(rng.normal(0, 1, 6).astype(np.float32))
    cot = rng.normal(0, 1, (2, 6, 6, 7)).astype(np.float32)
    return arrays, cot


@pytest.mark.parametrize("groups,dg,with_mask", [(1, 1, False),
                                                 (2, 2, True)],
                         ids=["v1", "v2_groups"])
def test_deform_conv2d_and_gradients_match_jax(groups, dg, with_mask):
    """Offsets of about 1.5 pixels carry taps past the border (zero
    padding); gradients of x, the offsets, the weight, the mask and the
    bias."""
    arrays, cot = _deform_inputs(8, groups, dg, with_mask)
    kw = dict(padding=1, deformable_groups=dg, groups=groups)

    def call(mod):
        def op(x, off, w, *rest):
            m = rest[0] if with_mask else None
            return mod.deform_conv2d(x, off, w, rest[-1], mask=m, **kw)
        return op

    diff = tuple(range(len(arrays)))
    want, jg = _jax_run(call(jops), arrays, diff, cot)
    got, tg = _port_run(call(tops), arrays, diff, cot)
    _within(got[0], want[0], NET_TOL, "deform_conv2d")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _within(a, b, NET_TOL, f"gradient {i}")


def test_deform_conv2d_stride_dilation_and_zero_offsets():
    """Stride 2 and dilation 2 against JAX; zero offsets give the plain
    convolution."""
    rng = np.random.RandomState(9)
    x = rng.normal(0, 1, (1, 3, 9, 8)).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 3, 3, 3)).astype(np.float32)
    off = rng.normal(0, 1, (1, 18, 4, 3)).astype(np.float32)
    kw = dict(stride=2, padding=1, dilation=2)
    want, _ = _jax_run(lambda a, o, b: jops.deform_conv2d(a, o, b, **kw),
                       (x, off, w))
    got = tops.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                             torch.from_numpy(w), **kw)
    _within(got.numpy(), want[0], NET_TOL, "strided")
    zero = tops.deform_conv2d(torch.from_numpy(x), torch.zeros(1, 18, 4, 3),
                              torch.from_numpy(w), **kw)
    plain = torch.nn.functional.conv2d(torch.from_numpy(x),
                                       torch.from_numpy(w), **kw)
    _within(zero.numpy(), plain.numpy(), NET_TOL, "zero offsets")


def test_DeformConv2D_layer_matches_jax():
    jlayer = jops.DeformConv2D(4, 5, 3, padding=1, deformable_groups=2)
    tlayer = tops.DeformConv2D(4, 5, 3, padding=1, deformable_groups=2)
    state = {n: np.asarray(v.data) for n, v in jlayer.state_dict().items()}
    assert sorted(state) == ["bias", "weight"]
    bound = np.sqrt(1.0 / 36)
    w = tlayer.weight.detach().numpy()
    assert w.shape == (5, 4, 3, 3) and np.abs(w).max() <= bound
    assert not tlayer.bias.detach().any()
    tlayer.set_state_dict(state)
    rng = np.random.RandomState(10)
    x = rng.normal(0, 1, (1, 4, 5, 5)).astype(np.float32)
    off = rng.normal(0, 1, (1, 36, 5, 5)).astype(np.float32)
    want = np.asarray(jlayer(jp.Tensor(x), jp.Tensor(off)).data)
    got = tlayer(torch.from_numpy(x), torch.from_numpy(off))
    _within(got.detach().numpy(), want, NET_TOL, "DeformConv2D")
    got.sum().backward()
    assert tlayer.weight.grad is not None and tlayer.bias.grad is not None


@pytest.mark.parametrize("clip,sxy", [(True, 1.0), (False, 1.2)])
def test_yolo_box_matches_jax(clip, sxy):
    rng = np.random.RandomState(11)
    x = rng.normal(0, 1, (2, 2 * 8, 3, 4)).astype(np.float32)
    img = np.array([[96, 128], [64, 100]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30], class_num=3, conf_thresh=0.5,
              downsample_ratio=32, clip_bbox=clip, scale_x_y=sxy)
    want, _ = _jax_run(jops.yolo_box, (x, img), **kw)
    got, _ = _port_run(tops.yolo_box, (x, img), **kw)
    assert (want[0] == 0).any() and (want[0] != 0).any()
    for g, w, what in zip(got, want, ("boxes", "scores")):
        assert g.shape == w.shape
        _close(g, w, what=what)


def _yolo_inputs(seed, classes=3):
    rng = np.random.RandomState(seed)
    x = (rng.normal(0, 1, (2, 3 * (5 + classes), 4, 4)) * 0.5).astype(
        np.float32)
    cxy = rng.uniform(0.1, 0.9, (2, 4, 2))
    wh = rng.uniform(0.05, 0.6, (2, 4, 2))
    gtb = np.concatenate([cxy, wh], -1).astype(np.float32)
    gtb[1, 3] = 0.0  # a padding row
    gtl = rng.randint(0, classes, (2, 4)).astype(np.int64)
    gts = rng.uniform(0.5, 1.0, (2, 4)).astype(np.float32)
    cot = rng.normal(0, 1, 2).astype(np.float32)
    return x, gtb, gtl, gts, cot


@pytest.mark.parametrize("mask,with_score,smooth", [
    ([6, 7, 8], False, True), ([0, 1, 2], True, False),
    ([3, 4, 5], True, True)])
def test_yolo_loss_and_gradient_match_jax(mask, with_score, smooth):
    """Seed 12 keeps the piecewise matching away from its edges: each
    real gt's best anchor leads the next by at least 0.066 of wh-IoU, and
    every prediction's largest IoU with a gt lies at least 0.094 from
    ``ignore_thresh`` 0.5 (two predictions are ignored)."""
    x, gtb, gtl, gts, cot = _yolo_inputs(12)
    kw = dict(anchors=YOLO_ANCHORS, anchor_mask=mask, class_num=3,
              ignore_thresh=0.5, downsample_ratio=32,
              use_label_smooth=smooth)
    if with_score:
        def jop(a, b, c, d):
            return jops.yolo_loss(a, b, c, gt_score=d, **kw)

        def top(a, b, c, d):
            return tops.yolo_loss(a, b, c, gt_score=d, **kw)
        arrays = (x, gtb, gtl, gts)
    else:
        def jop(a, b, c):
            return jops.yolo_loss(a, b, c, **kw)

        def top(a, b, c):
            return tops.yolo_loss(a, b, c, **kw)
        arrays = (x, gtb, gtl)
    want, jg = _jax_run(jop, arrays, (0,), cot)
    got, tg = _port_run(top, arrays, (0,), cot)
    assert got[0].shape == (2,) and (want[0] > 0).all()
    _within(got[0], want[0], NET_TOL, "yolo_loss")
    _within(tg[0], jg[0], NET_TOL, "d x")


def test_vision_ops_follow_their_inputs_device():
    """numpy inputs go to the current device (here the CPU); tensors stay
    where they are."""
    b = np.array([[0, 0, 2, 2]], np.float32)
    assert tops.box_area(b).device == tp.device.current_device()
    assert tops.prior_box(2, 2, 8, 8, (4.0,)).device.type == "cpu"
    out = tops.roi_align(torch.zeros(1, 1, 4, 4), torch.tensor(b))
    assert tuple(out.shape) == (1, 1, 7, 7)


@pytest.mark.parametrize("name", ["roi_align", "roi_pool"])
def test_16_bit_inputs_sample_in_f32_and_round_once(name):
    """A bf16 map is sampled with f32 weights and sums: the f32 result on
    the same values, rounded to bf16."""
    x, boxes, _ = _roi_inputs(13)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    op = getattr(tops, name)
    got = op(xb, torch.from_numpy(boxes), output_size=3, spatial_scale=0.5)
    want = op(xb.float(), torch.from_numpy(boxes), output_size=3,
              spatial_scale=0.5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
