"""The port's op namespace (port of ``paddle1_tpu/ops/__init__.py``) and
its hand-written CUDA kernels, each beside its plain PyTorch version.

``math_ops``, ``manip_ops`` and ``linalg_ops`` (also as ``linalg``) are
Paddle's tensor ops on torch functions; importing this package installs
them as methods of the Paddle ``Tensor`` (``patch.py``); the LoD
sequence ops (``sequence_ops``) are exported here too. Importing this
package builds and loads nothing: a kernel is compiled
(``ops/cuda/build.py``) the first time a CUDA tensor reaches it."""

from . import linalg_ops as linalg  # noqa: F401
from . import manip_ops, math_ops  # noqa: F401
from .linalg_ops import (cholesky, det, dist, eig, eigh, inv,  # noqa: F401
                         inverse, lstsq, lu, matrix_power, matrix_rank,
                         multi_dot, norm, pinv, qr, slogdet, solve, svd,
                         triangular_solve)
from .math_ops import *  # noqa: F401,F403
from .manip_ops import *  # noqa: F401,F403
from . import sequence_ops  # noqa: F401
from .sequence_ops import *  # noqa: F401,F403
from . import patch as _patch  # noqa: F401,E402  (installs Tensor methods)

# the linear algebra names imported above
_LINALG = [n for n, v in list(globals().items())
           if getattr(v, "__module__", None) == linalg.__name__]
__all__ = sorted(set(math_ops.__all__) | set(manip_ops.__all__) |
                 set(sequence_ops.__all__) | set(_LINALG)) + ["linalg"]
