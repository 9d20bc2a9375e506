"""Framework utilities (``paddle1_tpu.framework`` subset): ``save``,
``load`` and ``ParamAttr``."""

from .io import load, save  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
