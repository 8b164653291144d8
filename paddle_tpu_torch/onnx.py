"""``paddle.onnx`` (counterpart of ``paddle_tpu/onnx.py``): ``export``
needs the ``onnx`` package, as Paddle's needs paddle2onnx.  The port's
portable export is ``paddle.jit.save`` (a ``torch.export`` program)."""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    try:
        import onnx  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "paddle.onnx.export needs the 'onnx' package, which is not "
            "installed in this environment. Use paddle.jit.save(layer, "
            "path, input_spec=...) for the portable export "
            "instead.") from e
    raise NotImplementedError(
        "ONNX graph conversion is not implemented; use paddle.jit.save "
        "for the portable export.")
