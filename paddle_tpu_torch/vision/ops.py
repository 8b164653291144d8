"""The detection ops of ``paddle_tpu/vision/ops.py`` (boxes, IoU, NMS,
anchors, box coding, RoI align / pool, deformable convolution, the YOLO
box and loss) are not ported yet: each name raises, naming ROADMAP.md
Queue 1 item 3.5.1."""
from __future__ import annotations

__all__ = ["box_area", "box_iou", "iou_similarity", "box_clip",
           "box_coder", "nms", "multiclass_nms", "prior_box",
           "generate_anchors", "detection_map", "roi_align", "roi_pool",
           "deform_conv2d", "DeformConv2D", "yolo_box", "yolo_loss"]


def _waits(name):
    def op(*args, **kwargs):
        raise NotImplementedError(
            f"vision.ops.{name} is not ported yet: the detection ops come "
            f"after the vision slice (ROADMAP.md Queue 1 item 3.5.1)")
    op.__name__ = op.__qualname__ = name
    return op


for _name in __all__:
    globals()[_name] = _waits(_name)
del _name
