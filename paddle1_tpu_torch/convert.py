"""Weights across packages: the JAX package's functional state → a
``state_dict`` for the port's module of the same structure.

``paddle1_tpu`` layers expose ``functional_state()`` — ``{name: array}``
for every parameter and buffer, named by attribute path
(``encoder.layers.0.self_attn.q_proj.weight``). The port names its
modules the same way and keeps Paddle's layouts (``Linear.weight`` is
``[in_features, out_features]``), so the conversion is a copy with no
transpose: both packages then compute the same function.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .core.errors import InvalidArgumentError

__all__ = ["state_from_jax"]


def state_from_jax(arrays: Mapping[str, np.ndarray],
                   model: Optional[torch.nn.Module] = None
                   ) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` (the numpy view of
    ``Layer.functional_state()``) → ``{name: torch.Tensor}`` on the CPU.

    With ``model``, the names and shapes are checked against its
    ``state_dict()`` and each tensor takes that entry's dtype and device,
    so ``model.load_state_dict(state_from_jax(arrays, model))`` loads.
    Names that share one parameter in ``model`` (a tied weight, as in
    ``BertForPretraining``) must carry equal arrays; both then land on
    the one tensor."""
    out = {k: torch.from_numpy(np.array(v, copy=True))
           for k, v in arrays.items()}
    if model is None:
        return out
    ref = model.state_dict(keep_vars=True)
    missing = sorted(set(ref) - set(out))
    extra = sorted(set(out) - set(ref))
    if missing or extra:
        raise InvalidArgumentError(
            f"state_from_jax: names differ — missing {missing[:8]}, "
            f"unexpected {extra[:8]}")
    tied: Dict[int, str] = {}
    for k, t in ref.items():
        first = tied.setdefault(id(t), k)
        if first != k and not np.array_equal(np.asarray(arrays[k]),
                                              np.asarray(arrays[first])):
            # a tied weight (BERT's cls.decoder_weight IS the word
            # embedding) is one tensor here: both names must agree
            raise InvalidArgumentError(
                f"state_from_jax: {k} and {first} are one tied tensor in "
                "the port's module but differ in the JAX state")
        if tuple(out[k].shape) != tuple(t.shape):
            raise InvalidArgumentError(
                f"state_from_jax: {k} has shape {tuple(out[k].shape)}, the "
                f"port's module expects {tuple(t.shape)}")
        out[k] = out[k].to(dtype=t.dtype, device=t.device)
    return out
