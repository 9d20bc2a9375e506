"""Serving on PyTorch/CUDA (port of ``paddle1_tpu.serving``).

* :class:`InferenceEngine` — the eval-mode forward on micro-batches
  padded to shape buckets (``serve_buckets``), with warm-up and
  per-bucket counters.
* :class:`Batcher` / :class:`ServeFuture` — drain a bounded request
  queue into micro-batches (``serve_max_batch`` /
  ``serve_batch_timeout_ms``), pad to the bucket, run once, scatter the
  outputs through futures sharing one lazy readback.
* :class:`Server` — admission control (:class:`ServerOverloaded`),
  per-request deadlines (:class:`DeadlineExceeded`), live
  :class:`ServingMetrics` and the SIGTERM drain through ``core.health``.
* :class:`GenerationServer` over :class:`GenerationEngine` — generative
  serving with a dense or block-paged KV cache, speculative decoding
  (:class:`NGramSpeculator`, :class:`DraftModelSpeculator`), int8 decode
  weights, resume replay and KV-pressure preemption, serving
  :class:`CausalLM`.

Not ported yet (ROADMAP Queue 1): the fleets (``ServingFleet``,
``GenerationFleet``), autoscaling and traffic models, and the metrics
groups.
"""

from .batcher import Batcher, ServeFuture  # noqa: F401
from .engine import InferenceEngine, resolve_buckets  # noqa: F401
from .errors import (DeadlineExceeded, DeployFailed,  # noqa: F401
                     KVPageAccountingError, KVPoolExhausted, ReplicaFailed,
                     ScaleFailed, ServerClosed, ServerOverloaded,
                     SlotWedged, StreamCancelled, StreamFailed)
from .generate import (CausalLM, GenerationEngine,  # noqa: F401
                       GenerationServer, TokenStream, eager_generate)
from .metrics import Counter, Gauge, Histogram, ServingMetrics  # noqa: F401
from .paging import PARKING_PAGE, PagePool  # noqa: F401
from .server import Server  # noqa: F401
from .speculate import DraftModelSpeculator, NGramSpeculator  # noqa: F401

__all__ = ["InferenceEngine", "Batcher", "Server", "ServeFuture",
           "ServingMetrics", "Counter", "Gauge", "Histogram",
           "ServerOverloaded", "DeadlineExceeded", "ServerClosed",
           "ReplicaFailed", "DeployFailed", "SlotWedged",
           "StreamCancelled", "KVPoolExhausted", "StreamFailed",
           "KVPageAccountingError", "GenerationEngine",
           "GenerationServer", "TokenStream", "CausalLM",
           "resolve_buckets", "PagePool", "PARKING_PAGE",
           "NGramSpeculator", "DraftModelSpeculator", "ScaleFailed",
           "eager_generate"]
