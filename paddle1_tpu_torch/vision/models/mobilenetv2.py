"""Reference submodule spelling (``vision/models/mobilenetv2.py``): the
implementation lives in ``mobilenet.py``."""
from .mobilenet import MobileNetV2, mobilenet_v2  # noqa: F401

__all__ = ["MobileNetV2", "mobilenet_v2"]
