"""Loss layers (port of ``paddle1_tpu/nn/layer_loss.py``, its whole
``__all__``): each keeps its settings and calls its functional loss
(``nn/functional/loss.py``) in ``forward``. ``HSigmoidLoss`` owns the
tree's internal-node weights, with the JAX package's names and shapes."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from . import functional as F
from .initializer import Constant, XavierUniform
from .layer_base import Layer

__all__ = ["CrossEntropyLoss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss",
           "L1Loss", "MSELoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "SoftMarginLoss", "MultiLabelSoftMarginLoss",
           "CTCLoss", "HSigmoidLoss"]


class CrossEntropyLoss(Layer):
    """``F.cross_entropy`` with the given settings (a per-class ``weight``
    tensor, ``ignore_index``, ``reduction``, soft labels, ``axis``,
    ``use_softmax``, ``label_smoothing``)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """``F.hsigmoid_loss`` owning the tree's ``[num_classes - 1,
    feature_size]`` internal-node weight (XavierUniform) and bias (zeros;
    ``bias_attr=False`` drops it); with ``is_custom`` the tree comes with
    each call as ``path_table`` / ``path_code`` over ``num_classes``
    nodes."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise InvalidArgumentError(
                "HSigmoidLoss: num_classes must be >= 2 for the default tree")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.is_sparse = is_sparse
        n_nodes = num_classes - 1 if not is_custom else num_classes
        kw = dict(device=resolve_device(device), generator=generator)
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr,
            default_initializer=XavierUniform(), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [n_nodes], attr=bias_attr, is_bias=True,
            default_initializer=Constant(0.0), **kw)

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom and (path_table is None or path_code is None):
            raise InvalidArgumentError(
                "HSigmoidLoss: is_custom=True requires path_table and "
                "path_code")
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code,
                               is_sparse=self.is_sparse)
