"""MobileNetV1 against the JAX package on the CPU, and the full-width
MobileNetV2's size and state dict (``vision/models/mobilenet.py``; the
checks and tolerances are ``tests/test_torch_mobilenet.py``'s, whose
module docstring states them). A file of its own so that its JAX
compilation runs on another test worker than MobileNetV2's.
"""

import numpy as np
import pytest

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax

from test_torch_mobilenet import _states, check_forward_gradients_and_eval


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


@pytest.mark.parametrize("flags", ["kernels", "plain"])
def test_mobilenet_v1_forward_gradients_and_eval_match_the_reference(flags):
    check_forward_gradients_and_eval("mobilenet_v1", flags)


def test_full_width_mobilenet_v2_size_and_state_dict():
    """``mobilenet_v2()``: 3,504,872 parameters and 52 batch norms in both
    packages; the JAX package's state dict (Paddle names, running
    statistics) loads through the numpy conversion."""
    jp.seed(21)
    jm = jp.vision.models.mobilenet_v2()
    with tp.utils.unique_name.guard():
        tm = tp.vision.models.mobilenet_v2()
    count = lambda ps: sum(int(np.prod(p.shape)) for p in ps)  # noqa: E731
    assert count(tm.parameters()) == count(jm.parameters()) == 3504872
    bns = [m for m in tm.modules() if isinstance(m, tp.nn.BatchNorm2D)]
    assert len(bns) == 52
    assert len({int(b._num_features) for b in bns}) == 13
    assert all(b._num_features % 8 == 0 for b in bns)
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm.load_state_dict(state_from_jax(state, tm))
    got = _states(tm)
    assert sorted(got) == sorted(state)
    for k in ("features.0.conv.weight", "features.18.bn._variance",
              "classifier.1.weight", "features.17.conv.1.bn._mean"):
        np.testing.assert_array_equal(got[k], state[k])


def test_the_submodule_spellings_and_pretrained():
    from paddle1_tpu_torch.core.errors import UnimplementedError
    from paddle1_tpu_torch.vision.models import mobilenetv1, mobilenetv2
    assert mobilenetv2.mobilenet_v2 is tp.vision.models.mobilenet_v2
    assert mobilenetv1.MobileNetV1 is tp.vision.models.MobileNetV1
    with pytest.raises(UnimplementedError):
        tp.vision.models.mobilenet_v2(pretrained=True)
