"""Generative serving on PyTorch/CUDA: ``GenerationServer`` over
``GenerationEngine`` with a dense or block-paged KV cache, serving
``CausalLM`` (port of ``paddle1_tpu.serving``'s generation path)."""

from .errors import (DeadlineExceeded, KVPageAccountingError,  # noqa: F401
                     KVPoolExhausted, ServerClosed, ServerOverloaded,
                     StreamCancelled)
from .generate import (CausalLM, GenerationEngine,  # noqa: F401
                       GenerationServer, TokenStream)
from .metrics import ServingMetrics  # noqa: F401
from .paging import PARKING_PAGE, PagePool  # noqa: F401
