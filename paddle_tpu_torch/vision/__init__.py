"""``paddle.vision`` (counterpart of ``paddle_tpu/vision``): the model
zoo (LeNet, ResNet, VGG, MobileNet V1 / V2), the synthetic datasets, the
host-side transforms and ``vision.ops``, the detection ops (boxes, NMS,
anchors, box coding, RoI align / pool, deformable convolution, the YOLO
box and loss)."""
from . import datasets, models, ops, transforms  # noqa: F401
from .models import (VGG, LeNet, MobileNetV1,  # noqa: F401
                     MobileNetV2, ResNet, mobilenet_v1, mobilenet_v2,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     vgg11, vgg13, vgg16, vgg19)

__all__ = ["datasets", "models", "ops", "transforms", "LeNet", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
           "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]
