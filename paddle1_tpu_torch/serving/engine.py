"""Shape-bucketed inference: the batch serving engine (port of
``paddle1_tpu/serving/engine.py``).

:class:`InferenceEngine` runs a model's eval-mode forward on micro-batches
padded up to a fixed list of batch sizes (``serve_buckets``), so steady
serving runs a small, warm set of shapes.

There is no compile in the port: PyTorch runs eagerly. The JAX package
compiles the forward once per (bucket, inner signature) and counts the
compiles; here the first forward of each (bucket, inner signature) pays
the one-time costs instead (kernel builds, cuDNN's algorithm choice,
allocator growth), and ``compile_counts`` counts those first forwards
under the JAX package's name, so both packages report ``{bucket: 1}``
per warmed bucket and ``cache_stats()`` reads the same. ``warm_up`` runs
one such forward per bucket. ``bucket_cost`` (XLA cost analysis there)
is not ported: it raises until the cost census lands.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import flags as core_flags
from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError, UnimplementedError

__all__ = ["InferenceEngine", "resolve_buckets"]


def resolve_buckets(buckets=None, max_batch: Optional[int] = None,
                    spec_flag: str = "serve_buckets") -> Tuple[int, ...]:
    """Normalize the bucket list: explicit sequence > the ``spec_flag``
    flag > powers of two up to ``max_batch`` (the ``serve_max_batch``
    flag when None). Always sorted and deduped; an explicit ``max_batch``
    is always covered. The generation engine reuses the same policy for
    PROMPT-LENGTH buckets by passing ``spec_flag=
    "serve_gen_prefill_buckets"`` and the prompt capacity as
    ``max_batch`` (a different axis, so it never reads the batch-size
    flag)."""
    explicit_max = max_batch is not None
    if max_batch is None:
        max_batch = int(core_flags.flag("serve_max_batch"))
    if buckets is None:
        spec = core_flags.flag(spec_flag)
        if spec:
            try:
                buckets = [int(b) for b in str(spec).split(",")
                           if b.strip()]
            except ValueError:
                raise InvalidArgumentError(
                    f"{spec_flag} must be comma-separated ints, got "
                    f"{spec!r}") from None
    if buckets is None:
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(max_batch)
    out = sorted({int(b) for b in buckets})
    if not out or out[0] < 1:
        raise InvalidArgumentError(f"buckets must be >= 1, got {out}")
    if explicit_max and out[-1] < max_batch:
        out.append(int(max_batch))  # the requested ceiling must dispatch
    return tuple(out)


class InferenceEngine:
    """Eval-mode forward with bucket-padded dispatch.

    Parameters
    ----------
    model : a port ``nn.Layer`` (any ``torch.nn.Module``; forced into
        eval mode, run under ``torch.inference_mode``) or a plain
        callable ``fn(*tensors) -> tensor(s)``.
    buckets : batch-size buckets (see :func:`resolve_buckets`).
    input_specs : optional ``[(shape_without_batch, dtype), ...]``:
        enables :meth:`warm_up` without example data.
    metrics : optional ServingMetrics to mirror the first-forward counts
        into.

    A Layer's inputs go to its parameters' device; a callable's to the
    current place (``device_guard("cpu")`` for the CPU).
    """

    def __init__(self, model, buckets=None, max_batch: Optional[int] = None,
                 input_specs=None, metrics=None):
        self.metrics = metrics
        # first forwards per bucket (the JAX package's compile counts)
        # and dispatches per bucket
        self.compile_counts: Dict[int, int] = {}
        self.dispatch_counts: Dict[int, int] = {}
        self._warm: set = set()
        self._seen_inner_sigs: set = set()
        self._retrace_warned = False
        self._lock = threading.Lock()
        if isinstance(model, torch.nn.Module):
            model.eval()
            self._params = model.state_dict(keep_vars=True)
            first = next(iter(self._params.values()), None)
            self.device = first.device if first is not None \
                else resolve_device()
        elif callable(model):
            self._params = {}
            self.device = resolve_device()
        else:
            raise InvalidArgumentError(
                f"InferenceEngine needs a Layer or a callable, got "
                f"{type(model).__name__}")
        self._model = model
        self.input_specs = input_specs
        self.buckets = resolve_buckets(buckets, max_batch)

    # -- online-learning deltas ---------------------------------------------

    def _param(self, name: str) -> torch.Tensor:
        cur = self._params.get(name)
        if cur is None:
            raise InvalidArgumentError(
                f"param {name!r} not served by this engine (have "
                f"{sorted(self._params)}) — the delta publisher and the "
                "serving model disagree on the param name")
        return cur

    def update_param_rows(self, name: str, ids, rows) -> None:
        """Overwrite rows of one 2-D param in place (the serving half of
        the embedding delta loop): visible on the next dispatch."""
        with self._lock:
            cur = self._param(name)
            ids = np.asarray(ids, np.int64).reshape(-1)
            vals = np.asarray(rows)
            if cur.dim() != 2 or vals.ndim != 2 or \
                    vals.shape != (ids.shape[0], cur.shape[1]):
                raise InvalidArgumentError(
                    f"delta shape {vals.shape} does not fit param "
                    f"{name!r} of shape {tuple(cur.shape)} (need "
                    f"[{ids.shape[0]}, {cur.shape[-1]}])")
            if ids.size and (int(ids.max()) >= cur.shape[0]
                             or int(ids.min()) < 0):
                raise InvalidArgumentError(
                    f"delta ids out of range for param {name!r} with "
                    f"{cur.shape[0]} rows")
            with torch.no_grad():
                cur[torch.from_numpy(ids).to(cur.device)] = \
                    torch.from_numpy(vals).to(device=cur.device,
                                              dtype=cur.dtype)

    def param_rows(self, name: str, ids) -> np.ndarray:
        """Read rows of one 2-D served param (the parity probe of the
        delta loop)."""
        with self._lock:
            cur = self._param(name)
            ids = np.asarray(ids, np.int64).reshape(-1)
            if cur.dim() != 2:
                raise InvalidArgumentError(
                    f"param {name!r} is not 2-D (shape "
                    f"{tuple(cur.shape)})")
            if ids.size and (int(ids.max()) >= cur.shape[0]
                             or int(ids.min()) < 0):
                raise InvalidArgumentError(
                    f"row ids out of range for param {name!r} with "
                    f"{cur.shape[0]} rows")
            return cur.detach()[torch.from_numpy(ids).to(
                cur.device)].cpu().numpy()

    # -- bucketing ----------------------------------------------------------

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket covering ``rows``."""
        if rows < 1:
            raise InvalidArgumentError(f"need >= 1 row, got {rows}")
        for b in self.buckets:
            if rows <= b:
                return b
        raise InvalidArgumentError(
            f"{rows} rows exceed the largest bucket {self.buckets[-1]} "
            f"(buckets {list(self.buckets)}) — raise serve_max_batch/"
            "serve_buckets or split the request")

    @staticmethod
    def _inner_sig(arrays) -> tuple:
        return tuple((tuple(np.shape(a)[1:]), str(np.asarray(a).dtype))
                     for a in arrays)

    def _guard_retrace(self, sig) -> None:
        if sig in self._seen_inner_sigs:
            return
        if self._seen_inner_sigs and not self._retrace_warned \
                and core_flags.flag("jit_retrace_warn"):
            self._retrace_warned = True
            warnings.warn(
                "InferenceEngine saw a new non-batch signature "
                f"{sig} (seen {len(self._seen_inner_sigs)} before). "
                "Batch-size variation is absorbed by the buckets, but "
                "every distinct inner shape/dtype is another first "
                "forward per bucket — pad sequence dims to fixed lengths "
                "(set FLAGS_jit_retrace_warn=0 to silence).")
        self._seen_inner_sigs.add(sig)

    # -- dispatch -----------------------------------------------------------

    def pad_to_bucket(self, arrays: Sequence[np.ndarray]
                      ) -> Tuple[List[np.ndarray], int, int]:
        """Zero-pad the batch axis up to the covering bucket; returns
        (padded, rows, bucket)."""
        rows = int(np.shape(arrays[0])[0])
        for a in arrays[1:]:
            if int(np.shape(a)[0]) != rows:
                raise InvalidArgumentError(
                    "all inputs of one request batch must share the "
                    f"batch dim; got {[np.shape(a) for a in arrays]}")
        bucket = self.bucket_for(rows)
        if bucket == rows:
            return list(arrays), rows, bucket
        padded = []
        for a in arrays:
            a = np.asarray(a)
            pad = np.zeros((bucket - rows,) + a.shape[1:], a.dtype)
            padded.append(np.concatenate([a, pad], axis=0))
        return padded, rows, bucket

    def bucket_cost(self, padded: Sequence[np.ndarray]):
        """FLOPs + bytes of one bucket's forward: not ported (the JAX
        package asks XLA's cost analysis)."""
        raise UnimplementedError(
            "InferenceEngine.bucket_cost is not ported yet: the cost and "
            "HBM census (obs/costmodel.py) is ROADMAP Queue 1 item 9")

    def _forward(self, padded: Sequence[np.ndarray]) -> Tuple[Any, ...]:
        bucket = int(np.shape(padded[0])[0])
        key = (bucket, self._inner_sig(padded))
        if key not in self._warm:
            with self._lock:
                self._warm.add(key)
                self.compile_counts[bucket] = \
                    self.compile_counts.get(bucket, 0) + 1
            if self.metrics is not None:
                self.metrics.counter("compiles_total").inc()
                self.metrics.counter(f"compiles_bucket_{bucket}").inc()
        xs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
              for a in padded]
        with torch.inference_mode():
            out = self._model(*xs)
        if not isinstance(out, (list, tuple)):
            out = (out,)
        return tuple(out)

    def dispatch_padded(self, padded: Sequence[np.ndarray],
                        bucket: Optional[int] = None):
        """Run the bucket's forward on already-padded inputs (the
        Batcher path). Returns the output tensors WITHOUT reading back:
        the caller decides when to pay the device-to-host copy (the
        Batcher shares one readback across a whole micro-batch)."""
        if bucket is None:
            bucket = int(np.shape(padded[0])[0])
        self._guard_retrace(self._inner_sig(padded))
        with self._lock:
            self.dispatch_counts[bucket] = \
                self.dispatch_counts.get(bucket, 0) + 1
        return self._forward(padded)

    def dispatch(self, arrays: Sequence[np.ndarray]):
        """Pad + run. Returns (output tensors, rows, bucket)."""
        padded, rows, bucket = self.pad_to_bucket(arrays)
        return self.dispatch_padded(padded, bucket), rows, bucket

    def infer(self, arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Synchronous single-shot convenience: dispatch + read back +
        slice the padding off (one device-to-host copy per call: the
        cost the Batcher exists to amortize)."""
        outs, rows, _ = self.dispatch(arrays)
        return [o.detach().cpu().numpy()[:rows] for o in outs]

    # -- warmup / accounting ------------------------------------------------

    def warm_up(self, example: Optional[Sequence[np.ndarray]] = None
                ) -> int:
        """One forward per bucket at startup, so the first requests do
        not pay the first-forward costs. Needs ``input_specs`` or one
        ``example`` request. Returns the number of buckets warmed."""
        if example is not None:
            specs = [(tuple(np.shape(a)[1:]), str(np.asarray(a).dtype))
                     for a in example]
        elif self.input_specs:
            specs = [(tuple(s), str(np.dtype(d)))
                     for s, d in self.input_specs]
        else:
            raise InvalidArgumentError(
                "warm_up needs input_specs=[(shape_without_batch, "
                "dtype), ...] or an example request")
        done = 0
        for b in self.buckets:
            self._forward([np.zeros((b,) + tuple(shape), np.dtype(dt))
                           for shape, dt in specs])
            done += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._seen_inner_sigs.add(tuple(specs))
        return done

    def cache_stats(self) -> Dict[str, int]:
        """hits/misses across all buckets: first forwards are misses."""
        with self._lock:
            compiles = sum(self.compile_counts.values())
            dispatches = sum(self.dispatch_counts.values())
        return {"hits": dispatches - min(compiles, dispatches),
                "misses": compiles}
