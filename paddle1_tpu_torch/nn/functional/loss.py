"""Losses (port of ``paddle1_tpu/nn/functional/loss.py``, its whole
``__all__``).

Each loss is the JAX package's formula and a :func:`amp.cast_point` under
the name the JAX package passes to ``apply`` for it (``bce_with_logits``
for ``binary_cross_entropy_with_logits``). ``reduction`` is ``mean``,
``sum`` or ``none`` (``kl_div`` also ``batchmean``); another value raises
``InvalidArgumentError``, as the JAX package's ``_reduce`` does. No Pallas
kernel computes a loss, so ``ctc_loss`` runs on
``torch.nn.functional.ctc_loss`` where the JAX package runs on optax.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...amp import cast_point
from ...core.errors import InvalidArgumentError

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "l1_loss", "mse_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "ctc_loss", "log_loss", "square_error_cost",
    "sigmoid_focal_loss", "triplet_margin_loss", "soft_margin_loss",
    "multi_label_soft_margin_loss", "npair_loss", "dice_loss",
    "hsigmoid_loss",
]


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "none":
        return loss
    raise InvalidArgumentError(f"Unknown reduction {reduction!r}")


@cast_point("cross_entropy")
def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0,
                  name=None) -> torch.Tensor:
    """Cross entropy of ``input`` along ``axis``, the JAX package's arms:

    - ``use_softmax`` (default): ``input`` are logits and the log-softmax
      is taken in f32 whatever their dtype (a bf16 logit tensor under
      ``amp_dtype`` included); ``use_softmax=False``: ``input`` are
      probabilities, ``log(clip(input, 1e-15, 1))``.
    - Soft labels (``soft_label``, or a label of the input's dtype and
      shape): ``-sum(label * logp)``, reduced over every position.
    - Integer class labels (a trailing singleton axis is squeezed):
      ``-logp[label]``; labels equal to ``ignore_index`` contribute 0 and
      ``mean`` divides by the count of the others (at least 1). With a
      per-class ``weight`` ``[classes]``, each loss is scaled by its
      label's weight and ``mean`` divides by the sum of those weights
      (at least 1e-12), as the reference does; with soft labels the
      weight is dropped, as the JAX package drops it (``loss.py:45``).
    - ``label_smoothing`` ε mixes either label with the uniform
      distribution: ``(1 - ε) * label + ε / classes``.

    ``none`` returns the per-position losses, ``sum`` their sum. The loss
    is f32 for logits, the input's dtype for probabilities."""
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(f"Unknown reduction {reduction!r}")
    ax = axis % input.dim()
    n = input.shape[ax]
    logp = torch.log_softmax(input, dim=ax, dtype=torch.float32) \
        if use_softmax else torch.log(input.clamp(1e-15, 1.0))
    if soft_label or (label.dtype == input.dtype and
                      label.shape == input.shape):
        soft = label.to(logp.dtype)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-torch.sum(soft * logp, dim=ax), reduction)
    y = label.long()
    if y.dim() == input.dim():
        y = torch.squeeze(y, ax)
    valid = y != ignore_index
    idx = torch.unsqueeze(torch.where(valid, y, torch.zeros_like(y)), ax)
    loss = -torch.squeeze(torch.gather(logp, ax, idx), ax)
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * loss - \
            label_smoothing / n * torch.sum(logp, dim=ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        cw = torch.where(valid,
                         weight.to(loss.dtype)[torch.squeeze(idx, ax)],
                         torch.zeros_like(loss))
        loss = loss * cw
        if reduction == "mean":
            return torch.sum(loss) / torch.sum(cw).clamp(min=1e-12)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.sum(loss) / torch.sum(valid).clamp(min=1).to(loss.dtype)


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Per-position cross entropy with ``axis`` kept as a singleton
    (``reduction="none"``); with ``return_softmax``, also
    ``F.softmax(logits, axis)`` (the kernel's route, see
    ``activation.softmax``). Under ``auto_cast`` it casts where its two
    named ops cast, as the JAX package's does."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


@cast_point("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log x + (1 - y) log(1 - x))``, both logs of values clipped to
    ``[1e-12, 1]``, times ``weight``."""
    loss = -(label * torch.log(torch.clamp(input, 1e-12, 1.0)) +
             (1 - label) * torch.log(torch.clamp(1 - input, 1e-12, 1.0)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@cast_point("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``max(x, 0) - x y + log1p(exp(-|x|))``; with
    ``pos_weight`` the positive term scaled by it, as the reference's
    kernel does."""
    log1p_term = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (
            log1p_term + torch.clamp(-logit, min=0.0))
    else:
        loss = torch.clamp(logit, min=0.0) - logit * label + log1p_term
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _class_weighted(loss, y, valid, weight, reduction):
    """The JAX package's tail of ``nll_loss``: ``loss`` (0 at ignored
    positions) scaled by each label's class weight; ``mean`` divides by
    the sum of the valid positions' weights (at least 1e-12), or without
    ``weight`` by their count (at least 1)."""
    if weight is not None:
        cw = torch.where(valid, weight.to(loss.dtype)[y],
                         torch.zeros_like(loss))
        loss = loss * cw
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(cw), min=1e-12)
    elif reduction == "mean":
        return torch.sum(loss) / torch.clamp(
            torch.sum(valid.to(loss.dtype)), min=1.0)
    return _reduce(loss, reduction)


@cast_point("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` over log-probabilities ``input``: classes on axis
    1 of a ``[N, C]`` input, on the last axis of a higher-rank one (the
    JAX package's reading); labels equal to ``ignore_index`` give 0."""
    ax = 1 if input.dim() == 2 else input.dim() - 1
    yi = label.long()
    valid = yi != ignore_index
    y = torch.where(valid, yi, torch.zeros_like(yi))
    loss = -torch.squeeze(torch.gather(input, ax, torch.unsqueeze(y, ax)),
                          ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return _class_weighted(loss, y, valid, weight, reduction)


@cast_point("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


@cast_point("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):
    d = input - label
    return _reduce(d * d, reduction)


@cast_point("square_error_cost")
def square_error_cost(input, label):
    d = input - label
    return d * d


@cast_point("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Paddle's ``delta`` form: ``0.5 d^2`` where ``d = |x - y| < delta``,
    else ``delta * (d - 0.5 delta)``."""
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


@cast_point("kl_div")
def kl_div(input, label, reduction="mean", name=None):
    """``y (log y - input)`` over log-probabilities ``input`` (``log y`` of
    ``y`` clipped at 1e-12); ``batchmean``: the sum over the batch size."""
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@cast_point("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):
    return -(label * torch.log(input + epsilon) +
             (1 - label) * torch.log(1 - input + epsilon))


@cast_point("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


@cast_point("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    """``x`` where the label is 1, else ``max(0, margin - x)``."""
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


@cast_point("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` where the label is 1, else ``max(0, cos - margin)``,
    cos over the last axis (the norms' product at least 1e-12)."""
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1) *
        torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


@cast_point("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


@cast_point("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    """The mean over the last axis of ``-(y log sigmoid(x) + (1 - y) log
    sigmoid(-x))``, times ``weight``."""
    loss = -(label * tF.logsigmoid(input) +
             (1 - label) * tF.logsigmoid(-input))
    loss = torch.mean(loss, dim=-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@cast_point("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(0, d(a, pos) - d(a, neg) + margin)`` with ``d(u, v) =
    (sum(|u - v|^p + epsilon))^(1/p)`` over the last axis; ``swap`` takes
    the smaller of ``d(a, neg)`` and ``d(pos, neg)``."""
    def dist(u, v):
        return torch.sum(torch.abs(u - v) ** p + epsilon, dim=-1) ** \
            (1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


@cast_point("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """``a_t (1 - p_t)^gamma ce`` with ``ce`` the stable sigmoid cross
    entropy, divided by ``normalizer`` when given."""
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0.0) - logit * label + torch.log1p(
        torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@cast_point("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross entropy of ``anchor @ positive.T`` against the labels'
    equality pattern (each row normalized), plus ``l2_reg / 4`` times the
    mean squared norms of both."""
    sim = torch.matmul(anchor, positive.transpose(0, 1))
    eq = (labels[:, None] == labels[None, :]).to(sim.dtype)
    target = eq / torch.sum(eq, dim=-1, keepdim=True)
    ce = -torch.mean(torch.sum(target * torch.log_softmax(sim, dim=-1),
                               dim=-1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, dim=-1)) +
                    torch.mean(torch.sum(positive * positive, dim=-1))) * 0.25
    return ce + reg


@cast_point("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - (2 |x . onehot| + eps) / (|x| + |onehot| + eps))`` per
    sample, classes on the last axis, ``label`` with a trailing axis of 1."""
    oh = tF.one_hot(torch.squeeze(label.long(), -1),
                    int(input.shape[-1])).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * oh, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(oh, dim=dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


@cast_point("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs`` ``[T, N, C]`` (or ``[N, T, C]`` when its first
    axis is the labels' batch, the JAX package's reading), log-softmaxed
    first; ``labels`` ``[N, S]``; the lengths ``[N]``. ``mean`` averages
    each sample's loss over its label length (at least 1); ``sum`` and
    ``none`` as elsewhere. ``norm_by_times`` is taken and not read, as in
    the JAX package."""
    lp = log_probs
    if lp.dim() == 3 and lp.shape[0] == labels.shape[0]:
        lp = lp.transpose(0, 1)                     # [N, T, C] -> [T, N, C]
    lp = torch.log_softmax(lp, dim=-1)
    llen = label_lengths.long()
    loss = tF.ctc_loss(lp, labels.long(), input_lengths.long(), llen,
                       blank=blank, reduction="none")
    if reduction == "mean":
        return torch.mean(loss / torch.clamp(llen.to(loss.dtype), min=1.0))
    return _reduce(loss, reduction)


@cast_point("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss, ``[N, 1]`` unreduced: the sum over a
    label's path of ``softplus(pre) - bit * pre``, ``pre = x . w[node]
    (+ b[node])``. The default tree is the reference's complete binary
    tree over ``num_classes`` leaves (code ``c = label + num_classes``:
    node ``(c >> (i + 1)) - 1``, bit ``(c >> i) & 1``); a custom tree
    comes as ``path_table`` / ``path_code`` ``[N, L]``, negative entries
    padding. ``is_sparse`` is taken and not read."""
    if path_table is not None or path_code is not None:
        if path_table is None or path_code is None:
            raise InvalidArgumentError(
                "hsigmoid_loss: path_table and path_code come together")
        node = path_table.long()
        bits = path_code.to(torch.float32)
    else:
        max_len = max(1, int(math.ceil(math.log2(max(2, num_classes)))) + 1)
        c = label.long() + num_classes
        i = torch.arange(max_len, device=input.device)
        node = (c[:, None] >> (i[None, :] + 1)) - 1
        bits = ((c[:, None] >> i[None, :]) & 1).to(torch.float32)
    valid = node >= 0
    idx = torch.clamp(node, min=0)
    pre = torch.einsum("nd,nld->nl", input, weight[idx])
    if bias is not None:
        pre = pre + bias[idx]
    loss = tF.softplus(pre) - bits * pre
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return torch.sum(loss, dim=1, keepdim=True)
