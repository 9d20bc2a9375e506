"""ParamAttr — parameter attribute bundle (port of
``paddle1_tpu/framework/param_attr.py``, a host-only module kept here as
this package's own copy).

Carries name, initializer, learning-rate scale, regularizer,
trainability and clip opt-in for a to-be-created parameter;
``Layer.create_parameter`` reads it.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """Normalize user input: None → default attr; False → no parameter
        (bias=False); str → named; initializer → wrapped."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return None
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        # duck-typed initializer
        if callable(arg):
            return ParamAttr(initializer=arg)
        raise TypeError(f"Cannot interpret {arg!r} as ParamAttr")
