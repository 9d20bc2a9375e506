"""The port's ``ops.linalg_ops`` against ``paddle1_tpu/ops/linalg_ops.py``
on the same seeded numpy inputs (``tests/test_torch_op_parity.py``), f32.

Ops with a unique answer (``inv``, ``det``, ``solve``, ``norm``, ...)
are compared directly at 1e-4 (absolute and relative), gradients too.
Decompositions are unique only up to sign or phase: ``svd``, ``qr``,
``eigh`` and ``eig`` are held to their singular values or sorted
eigenvalues and to their reconstructions at 1e-4 (no gradient through
``svd``: the reference's backward through it raises). Dtype difference:
``eig``/``eigvals`` are complex64 in the port always, where the
reference's numpy gives real arrays when every eigenvalue is real (the
inputs here have complex eigenvalues, so both are complex).
"""

import numpy as np
import pytest
import torch

import paddle1_tpu_torch as tp
from paddle1_tpu.ops import linalg_ops as jl
from paddle1_tpu_torch.ops import linalg_ops as tl

from test_torch_op_parity import LINALG, R, ids, run
from test_torch_op_cases import linalg_cases


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


CASES = linalg_cases()
A = R((4, 4), 1) + 4 * np.eye(4, dtype=np.float32)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_linalg_op_matches_the_reference(case):
    run(case, jl, tl)


def test_linalg_namespace_matches_the_reference():
    import paddle1_tpu as jpkg
    for name in jl.__all__ + ["inverse"]:
        assert callable(getattr(tp.linalg, name)), name
    # the top-level names of paddle1_tpu/ops/__init__.py:8-12
    top = [n for n in ("cholesky", "det", "dist", "eig", "eigh", "inv",
                       "inverse", "lstsq", "lu", "matrix_power",
                       "matrix_rank", "multi_dot", "norm", "pinv", "qr",
                       "slogdet", "solve", "svd", "triangular_solve")
           if hasattr(jpkg, n)]
    assert top and all(getattr(tp, n) is getattr(tl, n) for n in top)
    x = torch.from_numpy(A.copy())
    np.testing.assert_allclose(tp.linalg.norm(x).numpy(),
                               np.sqrt((A * A).sum()), rtol=LINALG)
