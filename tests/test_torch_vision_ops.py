"""The port's ``vision.ops`` against ``paddle1_tpu/vision/ops.py`` on the
CPU: every case of ``vision_cases`` (``tests/test_torch_op_cases.py``:
``box_coder``, ``matrix_nms``, ``roi_align``, ``roi_pool``,
``prior_box``, ``generate_anchors``, ``distribute_fpn_proposals``,
``deform_conv2d``, ``yolo_loss``, ``read_file``, ``decode_jpeg``) through
both packages on the same
seeded numpy inputs (values, dtypes, gradients of the listed inputs),
``DeformConv2D`` with the JAX package's weights carried across, the
inventory with the reference's positional signatures, where host input
lands (the current place, mocked as the meta device), and the JAX
package's departures from the reference, each pinned (ROADMAP Queue 3,
by design). Tolerances are each case's (``RED`` 1e-5, f32).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.vision import ops as JV
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.vision import ops as TV

from test_torch_op_cases import R, ids, vision_cases
from test_torch_op_parity import run


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


CASES = vision_cases()
WAITING = set()     # the JPEG pair came with core/jpeg.py


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_vision_op_matches_the_reference(case):
    run(case, JV, TV)


def test_every_vision_op_but_the_jpeg_pair_is_ported_with_a_case():
    assert set(JV.__all__) - set(TV.__all__) == WAITING
    covered = {c.op for c in CASES} | {"iou", "yolo_box", "nms",
                                       "multiclass_nms", "DeformConv2D"}
    for name in TV.__all__:
        assert getattr(tp.vision.ops, name) is getattr(TV, name)
        assert name in covered, f"{name} has no case"


@pytest.mark.parametrize("name", sorted(set(JV.__all__) - WAITING))
def test_vision_op_positional_parameters_are_the_reference_s(name):
    def pos(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()
                if p.kind != p.KEYWORD_ONLY]
    jf, tf = getattr(JV, name), getattr(TV, name)
    if inspect.isclass(jf):
        jf, tf = jf.__init__, tf.__init__
    assert pos(tf) == pos(jf)


def test_deform_conv2d_layer_matches_the_reference():
    jp.seed(5)
    jl = JV.DeformConv2D(4, 6, 3, stride=1, padding=1,
                         deformable_groups=2, groups=2)
    with tp.utils.unique_name.guard():
        tl = TV.DeformConv2D(4, 6, 3, stride=1, padding=1,
                             deformable_groups=2, groups=2, device="cpu")
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    assert set(state) == set(tl.state_dict())
    tl.load_state_dict(state_from_jax(state, tl))
    x, off = R((2, 4, 5, 5), 70), R((2, 36, 5, 5), 71)
    mask = R((2, 18, 5, 5), 72, "u")
    jx = jp.to_tensor(x, stop_gradient=False)
    jy = jl(jx, jp.to_tensor(off), jp.to_tensor(mask))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl(tx, torch.from_numpy(off), torch.from_numpy(mask))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()),
                               rtol=1e-5, atol=1e-5)
    jy.sum().backward()
    ty.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-5)
    assert float(tx.grad.abs().max()) > 0
    np.testing.assert_allclose(tl.weight.grad.numpy(),
                               np.asarray(jl.weight.grad.numpy()),
                               rtol=1e-5, atol=1e-5)


# the JAX package's departures from the reference, kept in the port


def test_yolo_loss_reduces_over_the_batch_by_design():
    """The reference returns one loss a sample (``[N]``); the JAX package
    (``vision/ops.py:536-537``) returns their sum over ``N``: the port
    keeps that."""
    head = R((2, 27, 4, 4), 80)
    gt = np.concatenate([R((2, 3, 2), 81, "u"), R((2, 3, 2), 82, "u") * 0.4],
                        -1)
    lab = np.array([[0, 2, -1], [1, -1, -1]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23]
    both = TV.yolo_loss(torch.from_numpy(head), gt, lab, anchors, [0, 1, 2],
                        4, 0.7, 8)
    one = [TV.yolo_loss(torch.from_numpy(head[i:i + 1]), gt[i:i + 1],
                        lab[i:i + 1], anchors, [0, 1, 2], 4, 0.7, 8)
           for i in range(2)]
    assert both.dim() == 0
    np.testing.assert_allclose(float(both), float(sum(one)) / 2, rtol=1e-6)


def test_matrix_nms_takes_top_k_over_all_classes_by_design():
    """The JAX package ranks the ``nms_top_k`` candidates over every
    class together and does not read ``background_label``: the port
    keeps both."""
    rng = np.random.default_rng(83)
    xy = rng.uniform(0, 5, (8, 2))
    bx = np.concatenate([xy, xy + 2], 1).astype(np.float32)
    sc = rng.uniform(0.2, 1, (2, 8)).astype(np.float32)
    a = TV.matrix_nms(bx, sc, nms_top_k=5, background_label=0)
    b = TV.matrix_nms(bx, sc, nms_top_k=5, background_label=-1)
    assert torch.equal(a, b) and a.shape[0] <= 5
    assert set(a[:, 0].tolist()) <= {0.0, 1.0}


def test_roi_pool_is_a_bilinear_max_by_design():
    """``roi_pool`` is ``roi_align``'s 2 x 2 bilinear grid (not aligned)
    with a max a bin, not the reference's integer bins."""
    feat, rois = R((1, 2, 8, 8), 84), np.array([[1, 1, 6, 5]], np.float32)
    want = TV.roi_align(torch.from_numpy(feat), rois, None, 2, 1.0, 2,
                        False, _reduce="max")
    assert torch.equal(TV.roi_pool(torch.from_numpy(feat), rois, None, 2),
                       want)


def test_conv_transpose_output_size_is_ignored_by_design():
    """The JAX package's transposed convolutions accept ``output_size``
    and do not read it (``conv.py:223-224``): the output shape comes from
    ``output_padding`` alone, in both packages."""
    x, w = R((1, 2, 4, 4), 85), R((2, 3, 3, 3), 86)
    t = tp.nn.functional.conv2d_transpose(torch.from_numpy(x),
                                          torch.from_numpy(w), stride=2,
                                          output_size=[99, 99])
    j = jp.nn.functional.conv2d_transpose(jp.to_tensor(x), jp.to_tensor(w),
                                          stride=2, output_size=[99, 99])
    assert tuple(t.shape) == tuple(j.shape) == (1, 3, 9, 9)


class _MetaPlace:
    """A current place whose device is ``meta``: host data that an op
    sends to the current place shows up there, not on the CPU."""

    def torch_device(self):
        return torch.device("meta")


@pytest.fixture
def meta_place(monkeypatch):
    from paddle1_tpu_torch.core import place, tensor
    for mod in (place, tensor):
        monkeypatch.setattr(mod, "get_device", _MetaPlace)


_BOX = np.array([[0, 0, 4, 4]], np.float32)


@pytest.mark.parametrize("call", [
    lambda: TV.box_coder(_BOX, np.array([.1, .1, .2, .2], np.float32),
                         np.array([[1, 1, 3, 3]], np.float32)),
    lambda: TV.roi_align(R((1, 2, 8, 8), 901), _BOX, output_size=2),
    lambda: TV.roi_pool(R((1, 2, 8, 8), 902), _BOX, output_size=2),
    lambda: TV.prior_box(R((1, 2, 4, 4), 903), R((1, 3, 32, 32), 904),
                         [8.0])[0],
    lambda: TV.generate_anchors(16),
    lambda: TV.distribute_fpn_proposals(
        np.array([[0, 0, 40, 40], [0, 0, 300, 300]], np.float32),
        2, 5, 4, 224)[1],
], ids=["box_coder", "roi_align", "roi_pool", "prior_box",
        "generate_anchors", "distribute_fpn_proposals"])
def test_host_input_lands_on_the_current_place(meta_place, call):
    assert call().device.type == "meta"
