"""Reference submodule spelling (``vision/models/mobilenetv1.py``): the
implementation lives in ``mobilenet.py``."""
from .mobilenet import MobileNetV1, mobilenet_v1  # noqa: F401

__all__ = ["MobileNetV1", "mobilenet_v1"]
