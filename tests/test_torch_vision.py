"""The YOLOv3 inference slice of the PyTorch port against the JAX package,
on the CPU.

Inputs and weights come from numpy with a seed and go through both
packages; weights cross through ``paddle1_tpu_torch.convert``. Each test
runs under the JAX package's two flag sets: ``KERNELS`` (channels-last
region, the fused batch norm: the JAX side runs its Pallas kernels in
interpret mode, as its own tests do, and the port's wrappers run their
plain versions on CPU tensors) and ``PLAIN``. The CUDA kernel itself is
held to its plain version on the card by ``chip_smoke.py`` (phases 16-18).

The whole model is ``YOLOv3(num_classes=4)`` with the backbone cut to one
DarkBlock a stage, at batch 2 x 64 x 64. Its batch norms are calibrated
first (momentum 0, one training-mode forward in the JAX package, then
eval), so that each head carries signal: fresh running statistics make
every batch norm nearly the identity and the seeded convolutions shrink
the heads towards 0, where a parity check would prove nothing.

Greedy NMS can reorder under a 1e-6 change near a tie or a threshold, so
decoded boxes and scores are compared with a tolerance and the NMS
exactly, on identical numpy inputs given to both packages. Everything is
float32; each tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.autograd import engine as jag
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu.nn import functional as jF
from paddle1_tpu.nn.layer_norm_act import BatchNorm2D as JBN
from paddle1_tpu.ops import manip_ops as jmanip
from paddle1_tpu.vision import ops as jV
from paddle1_tpu.vision.models import yolo as jyolo
from paddle1_tpu_torch import nn as tnn
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.core.errors import UnimplementedError
from paddle1_tpu_torch.nn import functional as tF
from paddle1_tpu_torch.ops import fused_bn as tbn
from paddle1_tpu_torch.ops import manip_ops as tmanip
from paddle1_tpu_torch.vision import ops as tV
from paddle1_tpu_torch.vision.models import yolo as tyolo

KERNELS = dict(conv_nhwc="always", fused_bn="always", fused_bn_bwd="always")
PLAIN = dict(conv_nhwc="never", fused_bn="never", fused_bn_bwd="never")
FLAGS = pytest.mark.parametrize("flags", [KERNELS, PLAIN],
                                ids=["kernel", "plain"])
# one module: convolutions over up to 3 x 3 x 48 products and batch-norm
# sums over 50-200 rows, both summed in other orders in f32
MOD_TOL = dict(atol=1e-5, rtol=1e-5)
# the whole model: the same sums compounded through 36 conv + batch-norm
# layers; a head's error scales with the size of the terms its sums add,
# not with each output, so a head is held to HEAD_REL of its max abs
# value (chip_smoke.py's phase 18 holds the card's kernel path so too)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
HEAD_REL = 1e-4
# elementwise ops and gathers: the same f32 arithmetic
EXACT = dict(atol=0, rtol=0)
CUT = (1, 1, 1, 1, 1)
IMG, BATCH, CLASSES = 64, 2, 4


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(t):
    return np.asarray(t.numpy())


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


def _carry(jlayer, tlayer):
    tlayer.load_state_dict(state_from_jax(_state(jlayer), tlayer))
    return tlayer


def _channels_last(t):
    return t.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# leaky ReLU, interpolate, the shape ops


@FLAGS
@pytest.mark.parametrize("slope", [None, 0.1])
def test_leaky_relu_matches_jax(flags, slope):
    x = _x((2, 8, 5, 5), 1)
    x[0, 0, 0, :3] = [0.0, -0.0, 1e-30]
    kw = {} if slope is None else dict(negative_slope=slope)
    with jax_flags_guard(**flags):
        want = _np(jF.leaky_relu(to_tensor(x), **kw))
        want_layer = _np(paddle.nn.LeakyReLU(**kw)(to_tensor(x)))
    xt = _t(x).contiguous(memory_format=torch.channels_last)
    with tflags.flags_guard(**flags):
        got = tF.leaky_relu(xt, **kw)
        got_layer = tnn.LeakyReLU(**kw)(xt)
    np.testing.assert_allclose(got.numpy(), want, **EXACT)
    np.testing.assert_allclose(got_layer.numpy(), want_layer, **EXACT)
    assert _channels_last(got)


INTERP = [
    dict(scale_factor=2),                         # YOLOv3's two upsamples
    dict(scale_factor=2, data_format="NHWC"),
    dict(size=[7, 10]),                           # not a multiple of 5 x 4
    dict(size=[3, 9], data_format="NHWC"),        # 10 -> 3: half-pixel
    dict(size=3, data_format="NCW"),              # one spatial axis
    dict(scale_factor=[1.5, 0.5]),
]


@FLAGS
@pytest.mark.parametrize("kw", INTERP, ids=[str(sorted(k.items()))
                                            for k in INTERP])
def test_interpolate_nearest_matches_jax(flags, kw):
    fmt = kw.get("data_format", "NCHW")
    shape = {"NCHW": (2, 3, 10, 4), "NHWC": (2, 10, 4, 3),
             "NCW": (2, 3, 5)}[fmt]
    x = _x(shape, 2)
    with jax_flags_guard(**flags):
        want = _np(jF.interpolate(to_tensor(x), mode="nearest", **kw))
    with tflags.flags_guard(**flags):
        got = tF.interpolate(_t(x), mode="nearest", **kw)
        up = tF.upsample(_t(x), mode="nearest", **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **EXACT)
    np.testing.assert_allclose(up.numpy(), want, **EXACT)


def test_interpolate_half_pixel_rule_where_torch_nearest_differs():
    # 10 -> 3: output 1 samples floor(1.5 * 10 / 3) = 5 in the reference;
    # torch's "nearest" takes floor(1 * 10 / 3) = 3
    x = np.arange(10, dtype=np.float32).reshape(1, 1, 1, 10)
    want = _np(jF.interpolate(to_tensor(x), size=[1, 3], mode="nearest"))
    got = tF.interpolate(_t(x), size=[1, 3], mode="nearest").numpy()
    np.testing.assert_array_equal(got, want)
    assert want.ravel().tolist() == [1.0, 5.0, 8.0]
    # bilinear without align_corners is the reference's antialiased
    # jax.image.resize, not torch's bilinear
    want = _np(jF.interpolate(to_tensor(x), size=[1, 3], mode="bilinear"))
    got = tF.interpolate(_t(x), size=[1, 3], mode="bilinear").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(got, torch.nn.functional.interpolate(
        _t(x), size=[1, 3], mode="bilinear").numpy())


def test_interpolate_and_concat_keep_channels_last_memory():
    x = _t(_x((2, 8, 5, 5), 3)).contiguous(memory_format=torch.channels_last)
    u = tF.interpolate(x, scale_factor=2, mode="nearest")
    assert _channels_last(u) and not u.is_contiguous()
    np.testing.assert_array_equal(
        u.numpy(), torch.nn.functional.interpolate(x, scale_factor=2,
                                                   mode="nearest").numpy())
    c = tmanip.concat([u, u[:, :3]], axis=1)
    assert _channels_last(u[:, :3].contiguous(
        memory_format=torch.channels_last)) and c.shape == (2, 11, 10, 10)
    c = tmanip.concat([u, u], axis=1)
    assert _channels_last(c)


@FLAGS
def test_shape_ops_match_jax(flags):
    a, b = _x((2, 3, 4), 4), _x((2, 5, 4), 5)
    with jax_flags_guard(**flags):
        ja, jb = to_tensor(a), to_tensor(b)
        want = [_np(jmanip.concat([ja, jb], axis=1)),
                _np(jmanip.concat([ja, jb], axis=to_tensor(np.int32(-2)))),
                _np(jmanip.transpose(ja, [2, 0, 1])),
                _np(jmanip.stack([ja, ja], axis=1))]
        want_split = [_np(t) for t in jmanip.split(jb, [2, -1, 1], axis=1)]
        want_split += [_np(t) for t in jmanip.split(ja, 2, axis=2)]
    ta, tb = _t(a), _t(b)
    with tflags.flags_guard(**flags):
        got = [tmanip.concat([ta, tb], axis=1),
               tmanip.concat([ta, tb], axis=torch.tensor(-2)),
               tmanip.transpose(ta, [2, 0, 1]),
               tmanip.stack([ta, ta], axis=1)]
        got_split = tmanip.split(tb, [2, -1, 1], axis=1) + \
            tmanip.split(ta, 2, axis=2)
    for g, w in zip(got + got_split, want + want_split):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# yolo_box, nms, multiclass_nms


YOLO_BOX = [dict(), dict(clip_bbox=False), dict(scale_x_y=1.05),
            dict(iou_aware=True, iou_aware_factor=0.4)]


@FLAGS
@pytest.mark.parametrize("kw", YOLO_BOX, ids=["default", "no_clip",
                                              "scale_x_y", "iou_aware"])
def test_yolo_box_matches_jax(flags, kw):
    anchors = [10, 13, 16, 30, 33, 23]
    ch = 3 * (6 + CLASSES) if kw.get("iou_aware") else 3 * (5 + CLASSES)
    x = _x((2, ch, 6, 5), 6, scale=2.0)
    img = np.array([[48, 40], [30, 52]], np.int32)
    with jax_flags_guard(**flags):
        jb, js = jV.yolo_box(to_tensor(x), to_tensor(img), anchors,
                             CLASSES, 0.3, 8, **kw)
    xt = _t(x).contiguous(memory_format=torch.channels_last)
    with tflags.flags_guard(**flags):
        tb, ts = tV.yolo_box(xt, _t(img), anchors, CLASSES, 0.3, 8, **kw)
    assert tuple(tb.shape) == (2, 3 * 30, 4) and \
        tuple(ts.shape) == (2, 3 * 30, CLASSES)
    # sigmoid and exp in f32 by two libraries, scaled to ~50 pixels
    np.testing.assert_allclose(tb.numpy(), _np(jb), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), **MOD_TOL)
    assert (ts.numpy() == 0).any() and (ts.numpy() > 0).any()


def _boxes(n, seed, size=50.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size, (n, 2)).astype(np.float32)
    wh = rng.uniform(2, size / 2, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("kw", [dict(), dict(top_k=5), dict(cats=True),
                                dict(no_scores=True)],
                         ids=["plain", "top_k", "categories", "no_scores"])
def test_nms_matches_jax_exactly(kw):
    boxes = _boxes(40, 7)
    scores = np.random.default_rng(8).uniform(0, 1, 40).astype(np.float32)
    cats = np.random.default_rng(9).integers(0, 3, 40).astype(np.int64)
    args = dict(iou_threshold=0.3, top_k=kw.get("top_k"))
    if not kw.get("no_scores"):
        args["scores"] = scores
    if kw.get("cats"):
        args["category_idxs"] = cats
    want = _np(jV.nms(to_tensor(boxes), **{
        k: to_tensor(v) if isinstance(v, np.ndarray) else v
        for k, v in args.items()}))
    got = tV.nms(_t(boxes), **{k: _t(v) if isinstance(v, np.ndarray)
                               else v for k, v in args.items()})
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(keep_top_k=7),
                                dict(background_label=0, nms_top_k=10),
                                dict(score_threshold=0.99)])
def test_multiclass_nms_matches_jax_exactly(kw):
    boxes = _boxes(60, 10)
    scores = np.random.default_rng(11).uniform(0, 1, (3, 60)).astype(
        np.float32)
    want = _np(jV.multiclass_nms(to_tensor(boxes), to_tensor(scores), **kw))
    got = tV.multiclass_nms(boxes, scores, **kw)
    assert got.dtype == torch.float32 and got.shape[1:] == (6,)
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = tV.multiclass_nms(_t(boxes), _t(scores), **kw)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_iou_matches_jax():
    a, b = _boxes(5, 12), _boxes(7, 13)
    want = _np(jV.iou(to_tensor(a), to_tensor(b)))
    np.testing.assert_allclose(tV.iou(_t(a), _t(b)).numpy(), want,
                               **MOD_TOL)


# ---------------------------------------------------------------------------
# the YOLOv3 blocks at narrow widths


BLOCKS = {
    "ConvBNLeaky": (lambda m, **kw: m.ConvBNLeaky(8, 16, 3, stride=2, **kw),
                    (2, 8, 10, 10)),
    "DarkBlock": (lambda m, **kw: m.DarkBlock(16, **kw), (2, 16, 6, 6)),
    "YoloDetBlock": (lambda m, **kw: m.YoloDetBlock(24, 8, **kw),
                     (2, 24, 5, 5)),
}


@FLAGS
@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_match_jax_in_training_and_eval(flags, name):
    """A training-mode forward (batch statistics, blended into the
    running ones), then an eval-mode forward on those statistics:
    outputs and buffers."""
    make, shape = BLOCKS[name]
    paddle.seed(14)
    jb = make(jyolo)
    tb = _carry(jb, make(tyolo, device="cpu"))
    x, x2 = _x(shape, 15, 1.5), _x(shape, 16)
    flat = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    outs = {}
    for pkg, layer, run in (
            ("jax", jb, lambda a: tuple(_np(o) for o in flat(jb(
                to_tensor(a))))),
            ("torch", tb, lambda a: tuple(o.numpy() for o in flat(tb(
                _t(a)))))):
        guard = jax_flags_guard if pkg == "jax" else tflags.flags_guard
        layer.train()
        with guard(**flags):
            with (jag.no_grad() if pkg == "jax" else torch.no_grad()):
                train = run(x)
        layer.eval()
        with guard(**flags):
            with (jag.no_grad() if pkg == "jax" else torch.no_grad()):
                ev = run(x2)
        outs[pkg] = (train, ev)
    for (jt, je), (tt, te) in [(outs["jax"], outs["torch"])]:
        for a, b in zip(tt + te, jt + je):
            np.testing.assert_allclose(a, b, **MOD_TOL)
    jstate = _state(jb)
    for k, buf in tb.named_buffers():
        np.testing.assert_allclose(buf.numpy(), jstate[k], err_msg=k,
                                   **MOD_TOL)


# ---------------------------------------------------------------------------
# the whole model


def _calibrate_jax(model, x):
    """Running statistics := one batch's (Paddle's rule m * old + (1 - m)
    * batch at m = 0), in the JAX package's plain arm, then eval."""
    for layer in model.sublayers():
        if isinstance(layer, JBN):
            layer._momentum = 0.0
    model.train()
    with jag.no_grad(), jax_flags_guard(**PLAIN):
        model(to_tensor(x))
    model.eval()


@pytest.fixture(scope="module")
def jax_yolo():
    """The JAX model (its full state kept), cut to one DarkBlock a stage,
    calibrated on one seeded batch; a second batch is the input."""
    paddle.seed(21)
    jm = jyolo.YOLOv3(num_classes=CLASSES)
    full = _state(jm)
    jm.backbone = jyolo.DarkNet53(depths=CUT)
    _calibrate_jax(jm, _x((BATCH, 3, IMG, IMG), 22))
    x = _x((BATCH, 3, IMG, IMG), 23)
    return jm, full, _state(jm), x


@pytest.fixture(scope="module")
def jax_heads(jax_yolo):
    """The JAX model's heads under each flag set, and its decoded boxes
    and scores (``yolo_box`` per head, concatenated)."""
    jm, _, _, x = jax_yolo
    out = {}
    img = to_tensor(np.tile([[IMG, IMG]], (BATCH, 1)).astype(np.int32))
    for fid, flags in (("kernel", KERNELS), ("plain", PLAIN)):
        with jag.no_grad(), jax_flags_guard(**flags):
            heads = jm(to_tensor(x))
        dec = []
        for h, mask, stride in zip(heads, jm.anchor_masks, (32, 16, 8)):
            sub = [a for m in mask for a in jm.anchors[2 * m:2 * m + 2]]
            dec.append(jV.yolo_box(h, img, sub, CLASSES, 0.01, stride))
        out[fid] = ([_np(h) for h in heads],
                    np.concatenate([_np(b) for b, _ in dec], 1),
                    np.concatenate([_np(s) for _, s in dec], 1))
    return out


def _torch_yolo(state, **kw):
    tm = tyolo.YOLOv3(num_classes=CLASSES, device="cpu", **kw)
    tm.backbone = tyolo.DarkNet53(depths=CUT, device="cpu")
    tm.load_state_dict(state_from_jax(state, tm))
    return tm.eval()


def test_state_from_jax_loads_the_full_yolov3(jax_yolo):
    _, full, _, _ = jax_yolo
    tm = tyolo.yolov3(num_classes=CLASSES, device="cpu")
    sd = state_from_jax(full, tm)
    tm.load_state_dict(sd)
    assert set(tm.state_dict()) == set(full)
    assert sum(k.endswith("._mean") for k in full) == 72
    assert "backbone.stage4.8.conv2.bn._variance" in full and \
        "block3.tip.conv.weight" in full and "head5.bias" in full
    np.testing.assert_array_equal(
        tm.block4.body[2].conv.weight.detach().numpy(),
        full["block4.body.2.conv.weight"])
    with pytest.raises(UnimplementedError):
        tyolo.yolov3(pretrained=True)


@FLAGS
def test_yolov3_heads_and_postprocess_match_jax(jax_yolo, jax_heads, flags):
    jm, _, state, x = jax_yolo
    fid = "kernel" if flags is KERNELS else "plain"
    jheads, jboxes, jscores = jax_heads[fid]
    tm = _torch_yolo(state)
    with tflags.flags_guard(**flags), torch.no_grad():
        heads = tm(_t(x))
    for h, w, side in zip(heads, jheads, (2, 4, 8)):
        assert tuple(h.shape) == (BATCH, 3 * (5 + CLASSES), side, side)
        # calibrated: the heads carry signal in both packages
        assert float(h.std()) > 1e-2 and float(w.std()) > 1e-2
        np.testing.assert_allclose(h.numpy(), w, rtol=0,
                                   atol=HEAD_REL * float(np.abs(w).max()))
        assert _channels_last(h) == (flags is KERNELS)
    # decode where the heads lie, one copy to the host, NMS in numpy:
    # the decoded arrays within the model's tolerance of the JAX
    # package's, and the NMS exact on the JAX package's decoded arrays
    img = torch.tensor([[IMG, IMG]] * BATCH, dtype=torch.int32)
    with tflags.flags_guard(**flags):
        res = tm.postprocess(heads, img)
        dec = [tV.yolo_box(h, img, [a for m in mask for a in
                                    tm.anchors[2 * m:2 * m + 2]],
                           CLASSES, 0.01, s)
               for h, mask, s in zip(heads, tm.anchor_masks, (32, 16, 8))]
    tboxes = torch.cat([b for b, _ in dec], 1).numpy()
    tscores = torch.cat([s for _, s in dec], 1).numpy()
    # a head difference d moves a box edge by up to d times half the box's
    # unclipped size in pixels (exp(t) x anchors of up to 373 px, here
    # scaled to 64 px images): within MODEL_TOL of the heads, 1e-2 px
    np.testing.assert_allclose(tboxes, jboxes, atol=1e-2, rtol=1e-4)
    np.testing.assert_allclose(tscores, jscores, **MODEL_TOL)
    # on identical heads the two decodes differ by f32 rounding only
    same = [tV.yolo_box(_t(h), img, [a for m in mask for a in
                                     tm.anchors[2 * m:2 * m + 2]],
                        CLASSES, 0.01, s)
            for h, mask, s in zip(jheads, tm.anchor_masks, (32, 16, 8))]
    np.testing.assert_allclose(torch.cat([b for b, _ in same], 1).numpy(),
                               jboxes, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(torch.cat([s for _, s in same], 1).numpy(),
                               jscores, **MOD_TOL)
    for bi in range(BATCH):
        want = _np(jV.multiclass_nms(to_tensor(jboxes[bi]),
                                     to_tensor(jscores[bi].T),
                                     score_threshold=0.01))
        got = tV.multiclass_nms(jboxes[bi], jscores[bi].T,
                                score_threshold=0.01)
        np.testing.assert_array_equal(got.numpy(), want)
        # postprocess is that NMS on its own decoded arrays
        own = tV.multiclass_nms(tboxes[bi], tscores[bi].T,
                                score_threshold=0.01)
        np.testing.assert_array_equal(res[bi].numpy(), own.numpy())
        assert res[bi].device.type == "cpu" and 0 < res[bi].shape[0] <= 100


def test_kernel_path_gives_every_batch_norm_a_free_view(jax_yolo,
                                                        monkeypatch):
    """Under the channels-last region, interpolate and concat hand
    channels-last memory on: each of the cut model's 36 eval batch norms
    reaches the given-statistics wrapper with a free [rows, C] view (no
    copy), and the conv weights are held channels-last."""
    _, _, state, x = jax_yolo
    seen = []
    orig = tbn._norm_fwd
    monkeypatch.setattr(tbn, "_norm_fwd", lambda x2, *a: (
        seen.append(x2._base is not None and x2.is_contiguous()),
        orig(x2, *a))[1])
    with tflags.flags_guard(**KERNELS):
        tm = _torch_yolo(state)
        with torch.no_grad():
            tm(_t(x))
    assert len(seen) == 36 and all(seen)
    assert _channels_last(tm.block5.tip.conv.weight) and \
        not tm.block5.tip.conv.weight.is_contiguous()
