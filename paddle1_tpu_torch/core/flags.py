"""Global flag registry (port of ``paddle1_tpu/core/flags.py``).

A single process-wide registry of typed flags, set programmatically
(``set_flags`` / ``flags_guard``) or through ``FLAGS_<name>`` environment
variables read when the flag is defined (gflags-compatible behaviour).

Only the flags this package reads are defined, under the JAX package's
names and defaults. ``auto|always|never`` kernel flags resolve against
the tensor's device (:func:`flag_active`): ``auto`` means "the tensor
lies on a CUDA device", where the JAX package keys on the TPU backend.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from .errors import InvalidArgumentError

__all__ = ["define_flag", "get_flags", "set_flags", "flag", "flags_guard",
           "flag_active"]


@dataclass
class _FlagDef:
    name: str
    default: Any
    help: str
    type: type
    value: Any
    validator: Optional[Callable[[Any], bool]] = None


_registry: Dict[str, _FlagDef] = {}
_lock = threading.RLock()


def _coerce(raw: Any, ty: type) -> Any:
    if ty is bool:
        if isinstance(raw, bool):
            return raw
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return ty(raw)


def define_flag(name: str, default: Any, help: str = "",
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    """Register a flag. Environment variable ``FLAGS_<name>`` overrides the
    default at definition time (gflags-compatible behavior)."""
    with _lock:
        ty = type(default)
        value = default
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            value = _coerce(env, ty)
        if validator is not None and not validator(value):
            raise InvalidArgumentError(
                f"Invalid value {value!r} for flag {name}")
        _registry[name] = _FlagDef(name, default, help, ty, value, validator)


def flag(name: str) -> Any:
    """Fast single-flag read used by runtime internals."""
    try:
        return _registry[name].value
    except KeyError:
        raise InvalidArgumentError(
            f"Flag '{name}' has not been defined. Known flags: "
            f"{sorted(_registry)}") from None


def get_flags(flags) -> Dict[str, Any]:
    """Query flag values. ``flags`` may be a name or list of names."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: flag(name) for name in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flag values from a dict, with type coercion and validation."""
    if not isinstance(flags, dict):
        raise InvalidArgumentError("set_flags expects a dict of {name: value}")
    with _lock:
        for name, value in flags.items():
            if name not in _registry:
                raise InvalidArgumentError(f"Flag '{name}' is not defined")
            d = _registry[name]
            value = _coerce(value, d.type)
            if d.validator is not None and not d.validator(value):
                raise InvalidArgumentError(
                    f"Invalid value {value!r} for flag {name}")
            d.value = value


def flag_active(name: str, device) -> bool:
    """Resolve an ``auto|always|never`` kernel flag for a tensor on
    ``device`` (a ``torch.device``): ``always`` → True, ``auto`` → the
    device is CUDA, ``never`` → False."""
    v = flag(name)
    if v == "always":
        return True
    if v == "auto":
        return getattr(device, "type", device) == "cuda"
    return False


class flags_guard:
    """Context manager that temporarily overrides flags (test helper)."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None, **kw):
        self._overrides = {**(overrides or {}), **kw}
        self._saved: Dict[str, Any] = {}

    def __enter__(self):
        self._saved = get_flags(list(self._overrides))
        set_flags(self._overrides)
        return self

    def __exit__(self, *exc):
        set_flags(self._saved)
        return False


def _tri(v) -> bool:
    return v in ("auto", "always", "never")


def _define_builtin_flags() -> None:
    # kernel routing (JAX package: core/flags.py pallas_paged_attention,
    # fused_layer_norm)
    define_flag("pallas_paged_attention", "auto",
                "Hand-written CUDA paged-attention kernel for the paged "
                "decode path (the name is kept from the JAX package): "
                "auto (CUDA tensors only), always (the plain version on "
                "CPU tensors), never (plain PyTorch gather composition).",
                validator=_tri)
    define_flag("fused_layer_norm", "auto",
                "Hand-written CUDA LayerNorm forward kernel: auto (CUDA "
                "tensors only), always, never (plain composition).",
                validator=_tri)
    # training kernels (JAX package: flash_attention, flash_backward,
    # fused_adam). Same names and grammar, other defaults: the JAX
    # package keeps flash attention off below flash_auto_score_mb and
    # fused_adam at never, from TPU v5 lite sweeps that say nothing of
    # the H100. Here "auto" puts the kernels on every CUDA tensor they
    # support, so the card's own measurements (PERF.md) can decide the
    # defaults later. flash_auto_score_mb is not ported: its basis is a
    # TPU sweep.
    define_flag("flash_attention", "auto",
                "Hand-written CUDA flash-attention forward for "
                "scaled_dot_product_attention: auto (CUDA tensors only, "
                "dropout 0, no mask or a pure padding mask, supported "
                "shapes), always (the plain version on CPU tensors), "
                "never (dense composition).",
                validator=_tri)
    define_flag("flash_backward", "auto",
                "Hand-written CUDA flash-attention backward (dK/dV and dQ "
                "passes): auto (CUDA tensors only), always, never (plain "
                "recompute backward). Only read when the forward ran "
                "flash attention.",
                validator=_tri)
    define_flag("fused_adam", "auto",
                "Hand-written CUDA fused Adam/AdamW update, one launch "
                "over the whole parameter list: auto (CUDA parameters "
                "only), always, never (plain PyTorch update).",
                validator=_tri)
    # conv-net kernels (JAX package: fused_bn, fused_bn_bwd, conv_nhwc).
    # Same names and grammar. The JAX package's fused_bn_auto_mb size
    # crossover is a TPU measurement and has no counterpart here: under
    # "auto" every batch norm on the card takes the kernel.
    define_flag("fused_bn", "auto",
                "Hand-written CUDA fused batch norm forward (batch "
                "statistics + normalize + affine + residual + activation "
                "in one call; given-statistics normalize for eval and "
                "use_global_stats): auto (CUDA tensors), always (the "
                "plain version on CPU tensors), never (plain "
                "composition). On the card it needs a channels-last "
                "input (NHWC data_format or the conv_nhwc region), "
                "affine weight and bias, f32 or bf16 and C % 8 == 0, and "
                "raises otherwise.",
                validator=_tri)
    define_flag("fused_bn_bwd", "auto",
                "Hand-written CUDA fused batch norm backward (dx, dgamma, "
                "dbeta, dresidual): auto (CUDA tensors only), always, "
                "never (plain formula backward). Only read when the "
                "forward ran the fused kernel.",
                validator=_tri)
    define_flag("conv_nhwc", "auto",
                "Run NCHW-API image ops (conv2d, pooling, batch norm) on "
                "channels-last memory (torch.channels_last), so the "
                "batch-norm kernels see a free [rows, C] view: auto "
                "(CUDA tensors only), always, never.",
                validator=_tri)
    # eager softmax (JAX package: fused_softmax, auto = TPU only)
    define_flag("fused_softmax", "auto",
                "Hand-written CUDA row softmax for F.softmax over the last "
                "axis: auto (CUDA tensors only), always (the plain version "
                "on CPU tensors), never (torch.softmax, as the JAX "
                "package's jax.nn.softmax). Shapes and axes outside "
                "ops.softmax.supported() take the never arm; on the "
                "kernel's arm a dtype other than f32, bf16 or f16 raises.",
                validator=_tri)
    # collectives (JAX package: the same flag, there the coordination
    # service's initialization timeout)
    define_flag("collective_timeout_s", 1800.0,
                "Distributed rendezvous and collective bound, passed to "
                "torch.distributed.init_process_group as its timeout by "
                "init_parallel_env: a rank that cannot reach the others, "
                "or waits on a collective they never make, fails after "
                "this many seconds instead of hanging the job.",
                validator=lambda v: v > 0)
    # the batch-size bucket policy of resolve_buckets (serving/engine.py;
    # JAX package: core/flags.py serve_max_batch, serve_buckets)
    define_flag("serve_max_batch", 16,
                "Serving micro-batch ceiling: the Batcher dispatches as "
                "soon as this many request rows are queued (or the "
                "batch timeout fires). Must be covered by the largest "
                "shape bucket.",
                validator=lambda v: v >= 1)
    define_flag("serve_buckets", "",
                "Comma-separated batch-size buckets the InferenceEngine "
                "compiles (e.g. '1,4,16'); micro-batches pad up to the "
                "smallest covering bucket so the executable count stays "
                "fixed (the serving-side retrace guard). Empty = powers "
                "of two up to serve_max_batch.")
    # generic serving knobs the GenerationServer reads
    define_flag("serve_queue_depth", 256,
                "Bound on queued (admitted, not yet prefilled) generation "
                "requests; submissions beyond it are shed with "
                "ServerOverloaded.",
                validator=lambda v: v >= 1)
    define_flag("serve_deadline_ms", 0.0,
                "Default per-request wall deadline in ms (0 disables; "
                "submit() can override per request).",
                validator=lambda v: v >= 0)
    # generative serving (serving/generate.py)
    define_flag("serve_gen_slots", 16,
                "Decode slots in the GenerationEngine: the continuous-"
                "batching degree. Decode state is pinned at [slots] so "
                "every step runs the same shapes.",
                validator=lambda v: v >= 1)
    define_flag("serve_gen_max_seq", 256,
                "KV-cache sequence capacity per slot (prompt + generated "
                "tokens).",
                validator=lambda v: v >= 2)
    define_flag("serve_gen_prefill_buckets", "",
                "Comma-separated prompt-length buckets prompts pad up to "
                "(e.g. '16,64,256'). Empty = powers of two up to "
                "serve_gen_max_seq.")
    define_flag("serve_gen_token_budget", 128,
                "Server-side cap on generated tokens per request: a stream "
                "cut short by it fails mid-stream with DeadlineExceeded.",
                validator=lambda v: v >= 1)
    define_flag("serve_gen_stream_buffer", 64,
                "Bounded per-stream token buffer: a client not consuming "
                "its TokenStream parks its slot until the buffer drains.",
                validator=lambda v: v >= 1)
    define_flag("serve_gen_paged", False,
                "Block-paged KV cache: K/V live in a global [pages, "
                "page_size, heads, dim] pool per layer with a per-slot "
                "page table. Off = the dense [slots, max_seq] slot cache.")
    define_flag("serve_gen_kv_page_size", 16,
                "Tokens per KV page under serve_gen_paged.",
                validator=lambda v: v >= 1)
    define_flag("serve_gen_kv_pages", 0,
                "Page-pool capacity under serve_gen_paged; 0 = the dense "
                "equivalent (slots * ceil(max_seq/page_size) + 1 parking "
                "page).",
                validator=lambda v: v >= 0)
    define_flag("serve_gen_prefix_cache", 64,
                "Prefix-registry entries for prompt-page sharing under "
                "serve_gen_paged (0 disables sharing).",
                validator=lambda v: v >= 0)
    # fault injection and the input pipeline's resilience (io.DataLoader;
    # JAX package: core/flags.py ft_chaos, loader_*), with the JAX
    # package's names, defaults and help
    define_flag("ft_chaos", "",
                "Deterministic failure-injection spec armed by "
                "core.chaos.configure_from_flags (e.g. "
                "'nan_batch@3,ckpt_fail@2,preempt@7'; worker-level "
                "points take an optional rank qualifier: "
                "'worker_kill@5:1' = rank 1's 5th health beat). Empty "
                "disables. Each armed occurrence fires exactly once, so "
                "retried/replayed operations come back clean, and "
                "worker points fire in incarnation 0 only, so a "
                "supervisor-restarted rank replays clean.")
    define_flag("loader_bad_sample", "raise",
                "What the input pipeline does when one sample fetch "
                "fails (dataset __getitem__ raises, a reader item "
                "won't convert, or an armed corrupt_sample chaos "
                "point): raise (fail the epoch — today's semantics, "
                "the default), skip (drop the sample, count it), "
                "quarantine (drop + append {index, error, worker} to "
                "the loader's quarantine log and, when "
                "loader_quarantine_file is set, to that JSONL file).",
                validator=lambda v: v in ("raise", "skip", "quarantine"))
    define_flag("loader_max_worker_restarts", 2,
                "Per-worker re-spawn budget when a DataLoader worker "
                "process dies (OOM-kill, segfault) or is restarted by "
                "the input-stall watchdog; a worker exceeding it fails "
                "the epoch with the legacy sticky RuntimeError (or "
                "DataLoaderStalled for a stall).",
                validator=lambda v: v >= 0)
    define_flag("loader_stall_timeout_s", 0.0,
                "Input-stall watchdog: if no batch arrives within this "
                "many seconds the loader dumps worker liveness + the "
                "pending task map, then restarts the stalled worker "
                "(multi-process path, within the restart budget) or "
                "raises DataLoaderStalled. 0 disables (the default — "
                "a legitimately slow first batch must not be killed). "
                "While waiting, the loader calls health.beat() so the "
                "Supervisor doesn't mistake a slow loader for a hung "
                "trainer.",
                validator=lambda v: v >= 0)
    define_flag("loader_chaos_stall_s", 1.0,
                "How long the loader_stall chaos point wedges one "
                "batch/task (must exceed the loader_stall_timeout_s "
                "under test for the watchdog to trip).",
                validator=lambda v: v >= 0)
    define_flag("loader_quarantine_file", "",
                "Optional JSONL file the quarantine policy appends "
                "{index, error, worker} records to (the in-memory "
                "loader.quarantine list is always kept). Empty "
                "disables the file sink.")
    # what the copies of core/locks.py, obs/registry.py and obs/events.py
    # read (JAX package: the same flags)
    define_flag("debug_lock_sanitizer", False,
                "Runtime lock-order sanitizer (core/locks.py): hot-"
                "class locks built through core.locks.make_lock become "
                "order-recording wrappers — acquiring two locks in "
                "opposite orders anywhere in the process raises typed "
                "LockOrderError at the second site, and a marked "
                "blocking call (wire recv, future wait) while holding "
                "one raises BlockingUnderLockError. Off (the default) "
                "is structurally free: make_lock returns a plain "
                "threading.Lock.")
    define_flag("obs_metrics", False,
                "Per-step instrumentation into the process "
                "MetricsRegistry (obs.registry.metrics_on). Off by "
                "default; rare lifecycle counters (restarts, stalls, "
                "quarantines) record regardless.")
    define_flag("obs_events_file", "",
                "Structured JSONL lifecycle journal (restart, stall, "
                "quarantine): one JSON object per line, shared "
                "append-safely by every process of a job (propagated "
                "to workers via env). Empty disables.")


_define_builtin_flags()
