"""Autograd (port of ``paddle1_tpu/autograd``): ``paddle.grad``,
``backward``, ``no_grad`` and ``PyLayer`` over ``torch.autograd``."""

from .engine import (backward, enable_grad, grad,  # noqa: F401
                     is_grad_enabled, no_grad,
                     register_backward_end_callback, run_backward,
                     set_grad_enabled)
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
