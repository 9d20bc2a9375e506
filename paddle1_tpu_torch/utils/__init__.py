"""Utilities (``paddle.utils`` subset): ``unique_name``."""

from . import unique_name  # noqa: F401
