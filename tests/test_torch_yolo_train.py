"""YOLOv3 training (slice 3b) against the JAX package on the CPU:
``yolov3_loss`` (three heads, ``gt_scores``, label smoothing,
``scale_x_y``, ``ignore_thresh``) and ``vision.ops.yolo_loss`` on seeded
head outputs, value and gradient within 1e-5 (f32 sums over the cells in
another order); and three ``Momentum(1e-3, 0.9, L2Decay(5e-4))`` steps of
a YOLOv3 whose backbone is cut to one DarkBlock a stage
(``DarkNet53(depths=(1, 1, 1, 1, 1))``) at batch 2 x 64², through both
engines, each step from the same state, losses, parameters, running
statistics and velocities within 1e-4, under
the port's kernel flags (the batch norms through the kernels' wrappers,
their plain versions on the CPU) and its plain composition. The
batch-norm kernels' launch plans at the path's 72 training shapes (8 x
608²) are held in ``tests/test_torch_bn_plan.py``.
"""

import jax
import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core.tensor import Tensor as JTensor
from paddle1_tpu.vision import ops as JV
from paddle1_tpu.vision.models import yolo as jyolo
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.vision import ops as TV
from paddle1_tpu_torch.vision.models import yolo as tyolo

CLASSES, BATCH, IMG, BOXES = 80, 2, 64, 6
CUT = (1, 1, 1, 1, 1)
STEPS = 3
KERNELS = dict(conv_nhwc="always", fused_bn="always", fused_bn_bwd="always")
PLAIN = dict(conv_nhwc="never", fused_bn="never", fused_bn_bwd="never")


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _gt(seed, batch=BATCH, boxes=BOXES, classes=CLASSES):
    """Seeded boxes (centre-size, normalized), labels with -1 pads and
    mixup scores."""
    rng = np.random.default_rng(seed)
    box = np.concatenate([rng.uniform(0.1, 0.9, (batch, boxes, 2)),
                          rng.uniform(0.03, 0.7, (batch, boxes, 2))],
                         -1).astype(np.float32)
    lab = rng.integers(0, classes, (batch, boxes)).astype(np.int32)
    lab[1, boxes // 2:] = -1
    box[1, boxes // 2:] = 0.0
    score = rng.uniform(0.4, 1.0, (batch, boxes)).astype(np.float32)
    return box, lab, score


def _heads(seed, batch=BATCH, classes=CLASSES, sides=(2, 4, 8)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 3 * (5 + classes), s, s)) *
             1.5).astype(np.float32) for s in sides]


LOSS_KW = [
    {},
    {"gt": True, "use_label_smooth": True, "scale_x_y": 1.05,
     "ignore_thresh": 0.5},
    {"gt": True, "ignore_thresh": 0.0},
]


@pytest.mark.parametrize("kw", LOSS_KW, ids=["plain", "scores-smooth-scale",
                                              "ignore-all"])
def test_yolov3_loss_value_and_gradient_match_the_reference(kw):
    kw = dict(kw)
    box, lab, score = _gt(1)
    if kw.pop("gt", False):
        kw["gt_scores"] = score
    heads = _heads(2)
    jh = [jp.to_tensor(h, stop_gradient=False) for h in heads]
    jkw = {k: (jp.to_tensor(v) if k == "gt_scores" else v)
           for k, v in kw.items()}
    jl = jyolo.yolov3_loss(jh, jp.to_tensor(box), jp.to_tensor(lab),
                           num_classes=CLASSES, **jkw)
    jl.backward()
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    tl = tyolo.yolov3_loss(th, torch.from_numpy(box), torch.from_numpy(lab),
                           num_classes=CLASSES, **kw)
    tl.backward()
    assert tl.dim() == 0 and tl.dtype == torch.float32
    want = float(np.asarray(jl.numpy()))
    np.testing.assert_allclose(float(tl), want, rtol=1e-5)
    assert any(np.abs(np.asarray(j.grad.numpy())).max() > 0 for j in jh)
    for j, t in zip(jh, th):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()),
                                   rtol=1e-5, atol=1e-5)


def test_yolo_loss_one_head_matches_the_reference():
    box, lab, score = _gt(3, classes=6)
    head = _heads(4, classes=6, sides=(4,))[0]
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    jh = jp.to_tensor(head, stop_gradient=False)
    jl = JV.yolo_loss(jh, jp.to_tensor(box), jp.to_tensor(lab), anchors,
                      [3, 4, 5], 6, 0.6, 16, jp.to_tensor(score),
                      scale_x_y=1.2)
    jl.backward()
    th = torch.from_numpy(head).requires_grad_()
    tl = TV.yolo_loss(th, box, lab, anchors, [3, 4, 5], 6, 0.6, 16, score,
                      scale_x_y=1.2)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(np.asarray(jl.numpy())),
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh.grad.numpy()),
                               rtol=1e-5, atol=1e-5)


def test_yolov3_loss_of_a_bf16_head_is_f32():
    """The heads are read in f32 whatever their dtype (the engine's bf16
    mode hands it bf16 heads)."""
    box, lab, _ = _gt(5)
    heads = _heads(6)
    f32 = tyolo.yolov3_loss([torch.from_numpy(h) for h in heads], box, lab,
                            num_classes=CLASSES)
    bf = [torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
          for h in heads]
    low = tyolo.yolov3_loss(bf, box, lab, num_classes=CLASSES)
    low.backward()
    assert low.dtype == torch.float32 and bf[0].grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(low), float(f32), rtol=2e-2)


# ---------------------------------------------------------------------------
# three engine steps of the cut YOLOv3, both packages


def _batch(seed):
    rng = np.random.default_rng(seed)
    box, lab, score = _gt(seed + 1)
    return {"x": rng.standard_normal((BATCH, 3, IMG, IMG)).astype(
        np.float32), "gt_box": box, "gt_label": lab, "gt_score": score}


@pytest.fixture(scope="module")
def yolo_jax_run():
    """The JAX engine's three steps (its plain batch-norm arm, the JAX
    package's CPU default) from one seeded state: the state (parameters
    and running statistics) and the Momentum velocities before each step,
    and after the last, and each step's loss."""
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh
    jp.seed(31)
    jm = jyolo.YOLOv3(num_classes=CLASSES)
    jm.backbone = jyolo.DarkNet53(depths=CUT)
    jm.train()

    def jloss(m, b):
        return jyolo.yolov3_loss(
            m(JTensor(b["x"])), JTensor(b["gt_box"]),
            JTensor(b["gt_label"]), num_classes=CLASSES,
            gt_scores=JTensor(b["gt_score"]))
    jeng = JEngine(jm, jp.optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9, parameters=jm.parameters(),
        weight_decay=jp.regularizer.L2Decay(5e-4)), jloss,
        mesh=build_mesh(dp=1, devices=[jax.devices()[0]]))

    def snapshot():
        return ({k: np.asarray(v) for k, v in jeng.params.items()},
                {k: np.asarray(s["velocity"])
                 for k, s in jeng.opt_state[0].items()})
    states, losses = [snapshot()], []
    for i in range(STEPS):
        losses.append(float(jeng.step(_batch(40 + i))))
        states.append(snapshot())
    return states, losses


# a pre-activation this close to a leaky ReLU's kink may fall on either
# side in two f32 forwards that sum in different orders
KINK_TOL = 1e-4


def _leaky_layers(model):
    return [m for m in model.sublayers() if type(m).__name__ == "LeakyReLU"]


def _pieces(model, x):
    """The side of the kink of every leaky ReLU input of a training-mode
    forward of ``x`` in the plain composition (the arm held to the JAX
    engine): one bool tensor a call, in call order."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append(i[0].detach() > 0))
        for m in _leaky_layers(model)]
    try:
        with tflags.flags_guard(**PLAIN), torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return seen


class _OnPieces:
    """Forward hooks that give each leaky ReLU call the recorded side of
    the kink (``x`` or ``0.1 x``, differentiable), and record how far
    from the kink each input that changed side lay."""

    def __init__(self, model, pieces):
        self.model, self.pieces, self.far = model, pieces, []

    def __enter__(self):
        calls = iter(self.pieces)

        def hook(m, inputs, out):
            x, pos = inputs[0], next(calls)
            moved = pos != (x.detach() > 0)
            if bool(moved.any()):
                self.far.append(float(x.detach()[moved].abs().max()))
            return torch.where(pos, x, x * m.negative_slope)
        self.hooks = [m.register_forward_hook(hook)
                      for m in _leaky_layers(self.model)]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def _rel_err(got, want, floor):
    """The L2 norm of ``got - want`` over ``want``'s, that denominator at
    least ``floor``."""
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), floor))


@pytest.mark.parametrize("flags", [PLAIN, KERNELS], ids=["plain", "kernel"])
def test_cut_yolov3_three_momentum_steps_match_the_jax_engine(yolo_jax_run,
                                                              flags):
    """Each step is taken by both engines from the same parameters,
    running statistics and velocities (the JAX engine's, loaded into the
    port before it): taken apart, the f32 trajectories part by chaos at
    this size, not by a fault (the port's own two arms, which differ only
    in the batch norms' f32 rounding, give losses 8e-4 apart at the
    second step). The loss, every parameter and running statistic
    elementwise within 1e-4 (relative and absolute), and every velocity
    (at step 1 the gradient plus the decay) as the L2 norm of its error
    over the JAX engine's within 1e-4, that denominator at least 1e-2 of
    the largest velocity's. The kernel arm's batch norms (the kernels'
    plain versions: a one-pass variance) put two of the first step's
    leaky ReLU inputs, within 6e-6 of 0, on the other side of the kink
    than the plain composition does, which moves the early stages'
    gradients by 5e-3; so each step of the kernel arm takes the leaky
    ReLUs on the plain composition's pieces (``_OnPieces``), inputs that
    change side lying within ``KINK_TOL`` of the kink."""
    states, jlosses = yolo_jax_run
    with tp.utils.unique_name.guard():
        tm = tyolo.YOLOv3(num_classes=CLASSES, device="cpu")
        tm.backbone = tyolo.DarkNet53(depths=CUT, device="cpu")
    tm.train()

    def loss(m, b):
        return tyolo.yolov3_loss(m(b["x"]), b["gt_box"], b["gt_label"],
                                 num_classes=CLASSES,
                                 gt_scores=b["gt_score"])
    opt = tp.optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9, parameters=tm.parameters(),
        weight_decay=tp.regularizer.L2Decay(5e-4))
    eng = tp.distributed.ParallelEngine(tm, opt, loss)
    params = dict(tm.named_parameters())
    assert sum(k.endswith("._mean") for k in tm.state_dict()) == 36
    far = []
    for i in range(STEPS):
        before, velocity = states[i]
        batch = _batch(40 + i)
        tm.load_state_dict(state_from_jax(before, tm))
        pieces = _pieces(tm, batch["x"]) if flags is KERNELS else None
        tm.load_state_dict(state_from_jax(before, tm))
        for k, q in params.items():
            opt._slots_for(q)["velocity"].copy_(torch.from_numpy(
                velocity[k]))
        with tflags.flags_guard(**flags):
            if pieces is None:
                got = float(eng.step(batch))
            else:
                with _OnPieces(tm, pieces) as on:
                    got = float(eng.step(batch))
                far += on.far
        after, jvel = states[i + 1]
        what = f"step {i + 1}"
        np.testing.assert_allclose(got, jlosses[i], rtol=1e-4, atol=1e-4)
        sd = tm.state_dict()
        assert set(sd) == set(after)
        for name, t in sd.items():
            np.testing.assert_allclose(t.numpy(), after[name],
                                       err_msg=f"{what} {name}",
                                       rtol=1e-4, atol=1e-4)
        floor = 1e-2 * max(np.linalg.norm(v) for v in jvel.values())
        for k, q in params.items():
            err = _rel_err(opt._slots_for(q)["velocity"].numpy(), jvel[k],
                           floor)
            assert err <= 1e-4, (what, k, err)
    assert max(far, default=0.0) <= KINK_TOL, far
    assert jlosses[-1] < jlosses[0]
