#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle1_tpu_torch``) on one CUDA card.

Run from the repo root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. **Card and build.** Print the card's name and power limit (nvidia-smi),
   then build every CUDA kernel of the serving path from
   ``paddle1_tpu_torch/ops/cuda/*.cu`` (one nvcc per source, in parallel).
2. **Kernels.** Hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes (paged attention also with f32
   queries over bf16 pools), and time kernel, plain version and
   (where one exists) the single PyTorch library call computing the same
   function. Times are device times from CUDA events around a replayed
   CUDA graph of many calls, so host launch overhead is not counted.
3. **Serving (the main path).** ``GenerationServer`` over ``CausalLM`` at
   the README width (vocab 32000, d_model 512, 8 heads, 12 layers,
   max_seq 512, seeded random weights), paged KV (page 16), 16 slots:
   10 staggered greedy and sampled requests, streamed and drained. The
   kernel launch counters are zeroed just before and read just after;
   the drain report must show ``unaccounted == 0`` and
   ``kv_pages_owed == 0``.
4. **Reference checks.** One greedy request is re-run alone through the
   engine (tokens must equal the served ones) and teacher-forced through
   the plain-version forward (no kernels) on the card: per-step logits
   agree to 1e-3 abs. A short dense-cache (``paged=False``) run at depth 2
   checks the other cache discipline.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
VOCAB, D_MODEL, HEADS, LAYERS, MAX_SEQ, FFN = 32000, 512, 8, 12, 512, 128
SLOTS, PAGE = 16, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (published peak)
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PA_TOL, LN_TOL, LOGIT_TOL = 2e-5, 1e-5, 1e-3
# bf16 outputs: kernel and plain version both round an f32 result to bf16,
# so they may differ by one rounding step, at most 2^-7 of the value
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0].strip()


def graph_time_ms(calls, reps=20):
    """Mean device time of one call: the calls are captured once into a
    CUDA graph, the graph is replayed ``reps`` times between CUDA events.
    Each call runs once eagerly first (lazy init, allocations)."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def paged_case(rng, dev, w, n_pools):
    """Serving-shaped paged attention inputs: ``n_pools`` K/V pool pairs
    [513, 16, 8, 64] (one per layer, so timing does not sit in L2), a
    [16, 32] table with each slot's chain drawn from a shuffled free list
    and the rest parked on page 0, bases in 0..500 and two fully parked
    slots (base 0, whole row on page 0)."""
    hd = D_MODEL // HEADS
    mpps = MAX_SEQ // PAGE
    n_pages = SLOTS * mpps + 1
    q = torch.from_numpy(rng.standard_normal(
        (SLOTS, w, HEADS, hd)).astype(np.float32)).to(dev)
    pools = [(torch.randn(n_pages, PAGE, HEADS, hd, device=dev),
              torch.randn(n_pages, PAGE, HEADS, hd, device=dev))
             for _ in range(n_pools)]
    base = rng.integers(0, min(500, MAX_SEQ - w) + 1, SLOTS).astype(np.int32)
    base[[3, 11]] = 0
    table = np.zeros((SLOTS, mpps), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for s in range(SLOTS):
        if s in (3, 11):
            continue  # parked slot: every entry stays on page 0
        n = -(-(int(base[s]) + w) // PAGE)
        table[s, :n] = [free.pop() for _ in range(n)]
    return (q, pools, torch.from_numpy(table).to(dev),
            torch.from_numpy(base).to(dev))


def paged_bound_ms(q, kp, base, w):
    """Least time for the work the kernel must do on these inputs: read q,
    the K/V rows some query row can see (positions < base + W, one
    head's row is its own 256 B, so no whole page is needed), the table
    entries that map them and the bases, write out; ~4 flops per (query
    row, visible key, dim) for QK^T and PV."""
    s_, _, h, d = q.shape
    b = base.cpu().numpy().astype(np.int64)
    rows = np.minimum(b + w, MAX_SEQ)
    live_pages = -(-rows // PAGE)
    kv_bytes = int(rows.sum()) * h * d * kp.element_size() * 2
    io_bytes = (2 * q.numel() * q.element_size() + int(live_pages.sum()) * 4
                + s_ * 4)
    visible = sum(int(b[s] + 1 + i) for s in range(s_) for i in range(w))
    flops = 4.0 * visible * h * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ln_bound_ms(rows, h):
    t_bytes = (2 * rows * h * 4 + 2 * h * 4) / HBM_BYTES_PER_S
    t_ops = 8.0 * rows * h / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(dev):
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED)
    out = {}

    cases = []
    # the decode step (the line's main case), a W=4 window, and f32 q
    # over bf16 pools (a bf16 KV cache under an f32 model)
    for w, kv_dtype in ((1, torch.float32), (4, torch.float32),
                        (1, torch.bfloat16)):
        q, pools, table, base = paged_case(rng, dev, w, n_pools=LAYERS)
        pools = [(kp.to(kv_dtype), vp.to(kv_dtype)) for kp, vp in pools]
        live = base >= 0
        tag = f"W={w} kv={str(kv_dtype).split('.')[-1]}"
        errs = []
        for kp, vp in pools[:2]:
            got = pa.paged_attention(q, kp, vp, table, base)
            want = pa.paged_attention_ref(q, kp, vp, table, base)
            torch.cuda.synchronize()
            errs.append(float((got - want)[live].abs().max()))
            check(bool(torch.isfinite(got).all()) and got.dtype == q.dtype,
                  f"paged_attention {tag}: non-finite output or a dtype "
                  f"other than q's")
        err = max(errs)
        check(err <= PA_TOL, f"paged_attention {tag}: max abs err {err} > "
              f"{PA_TOL}")
        ms = graph_time_ms([lambda kp=kp, vp=vp: pa.paged_attention(
            q, kp, vp, table, base) for kp, vp in pools])
        plain = graph_time_ms([lambda kp=kp, vp=vp: pa.paged_attention_ref(
            q, kp, vp, table, base) for kp, vp in pools])
        bound, by = paged_bound_ms(q, pools[0][0], base, w)
        cases.append(dict(shape=f"q{list(q.shape)} pool{list(pools[0][0].shape)}"
                          f" table{list(table.shape)}", window=w,
                          kv_dtype=str(kv_dtype), max_abs_err=err, ms=ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=None))
        log(f"paged_attention {tag}: max_abs_err={err:.3e} kernel={ms:.5f}ms"
            f" plain={plain:.5f}ms bound={bound:.5f}ms ({by})")
        del pools
    out["paged_attention"] = cases

    cases = []
    for rows, h in ((SLOTS, D_MODEL), (512, D_MODEL), (37, 1000)):
        x = torch.from_numpy((rng.standard_normal((rows, h)) * 2 + 0.3)
                             .astype(np.float32)).to(dev)
        w_ = torch.from_numpy(rng.standard_normal(h).astype(np.float32)
                              ).to(dev)
        b_ = torch.from_numpy(rng.standard_normal(h).astype(np.float32)
                              ).to(dev)
        got = ln.fused_layer_norm(x, w_, b_)
        want = ln.layer_norm_ref(x, w_, b_)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= LN_TOL, f"layer_norm rows={rows} H={h}: max abs err "
              f"{err} > {LN_TOL}")
        ms = graph_time_ms([lambda: ln.fused_layer_norm(x, w_, b_)] * 24)
        plain = graph_time_ms([lambda: ln.layer_norm_ref(x, w_, b_)] * 24)
        lib = graph_time_ms([lambda: torch.nn.functional.layer_norm(
            x, (h,), w_, b_, 1e-5)] * 24)
        bound, by = ln_bound_ms(rows, h)
        cases.append(dict(shape=f"x[{rows}, {h}]", max_abs_err=err, ms=ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=lib))
        log(f"layer_norm rows={rows} H={h}: max_abs_err={err:.3e} "
            f"kernel={ms:.5f}ms plain={plain:.5f}ms library={lib:.5f}ms "
            f"bound={bound:.5f}ms ({by})")
    out["layer_norm"] = cases

    # the kernels' second storage type, one decode-shaped case each
    bf = torch.bfloat16
    q, pools, table, base = paged_case(rng, dev, 1, n_pools=1)
    kp, vp = (t.to(bf) for t in pools[0])
    pairs = {"paged_attention": (
        pa.paged_attention(q.to(bf), kp, vp, table, base),
        pa.paged_attention_ref(q.to(bf), kp, vp, table, base))}
    x = torch.randn(SLOTS, D_MODEL, device=dev).to(bf)
    w_, b_ = (torch.randn(D_MODEL, device=dev).to(bf) for _ in range(2))
    pairs["layer_norm"] = (ln.fused_layer_norm(x, w_, b_),
                           ln.layer_norm_ref(x, w_, b_))
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        check(got.dtype == bf, f"{name} bf16: output dtype {got.dtype}")
        got, want = got.float(), want.float()
        excess = float(((got - want).abs() - BF16_REL * want.abs()).max())
        check(excess <= BF16_ABS, f"{name} bf16: differs from the plain "
              f"version by more than one bf16 rounding step ({excess})")
        out[name + "_bf16"] = {"shape": list(got.shape),
                               "max_abs_err": float((got - want).abs().max()),
                               "excess_over_rounding": excess}
        log(f"{name} bf16: max_abs_err={out[name + '_bf16']['max_abs_err']:.3e}"
            f" (within one bf16 rounding step)")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path


def make_requests(rng):
    lens = [5, 17, 33, 64, 90, 128, 150, 200, 12, 48]
    reqs = []
    for i, n in enumerate(lens):
        prompt = rng.integers(3, VOCAB, n).tolist()
        kw = dict(max_new_tokens=int(32 + (i * 7) % 33))
        if i % 2:
            kw.update(temperature=0.8, top_k=40, seed=100 + i)
        reqs.append((prompt, kw))
    return reqs


def serve(srv, reqs):
    """Staggered arrivals: 4 requests, then 3 more once the first has
    streamed 4 tokens, then the rest once it has 12."""
    streams = []
    waves = [(reqs[:4], 0), (reqs[4:7], 4), (reqs[7:], 12)]
    for wave, after in waves:
        t0 = time.monotonic()
        while streams and len(streams[0].tokens) < after and \
                not streams[0].done() and time.monotonic() - t0 < 120:
            time.sleep(0.001)
        streams += [srv.submit(p, **kw) for p, kw in wave]
    outs = [s.result(timeout=300) for s in streams]
    return streams, outs


def serving_phase(dev):
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                           GenerationServer)
    gen = torch.Generator().manual_seed(SEED)
    lm = CausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, dim_feedforward=FFN,
                  num_layers=LAYERS, max_seq=MAX_SEQ, generator=gen)
    check(all(p.device.type == "cuda" for p in lm.parameters()),
          "CausalLM did not default to the card")
    n_params = sum(p.numel() for p in lm.parameters())
    eng = GenerationEngine(lm, slots=SLOTS, max_seq=MAX_SEQ, eos_id=2,
                           paged=True, page_size=PAGE)
    srv = GenerationServer(eng, queue_depth=64, warmup=True).start()
    reqs = make_requests(np.random.default_rng(SEED + 1))
    torch.cuda.synchronize()

    # the warm-up's steps ran before the counters were zeroed
    steps0 = eng.decode_dispatch_count
    prefills0 = sum(eng.prefill_dispatch_counts.values())
    pa.paged_attention.launches = 0
    ln.fused_layer_norm.launches = 0
    t0 = time.perf_counter()
    streams, outs = serve(srv, reqs)
    rep = srv.drain(timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.paged_attention.launches,
                "layer_norm": ln.fused_layer_norm.launches}

    check(rep["fatal"] is None, f"generation loop died: {rep['fatal']}")
    check(rep["unaccounted"] == 0, f"unaccounted={rep['unaccounted']}")
    check(rep["kv_pages_owed"] == 0, f"kv_pages_owed={rep['kv_pages_owed']}")
    check(rep["tokens_owed"] == 0, f"tokens_owed={rep['tokens_owed']}")
    check(rep["completed"] == len(reqs), f"completed {rep['completed']} of "
          f"{len(reqs)}")
    for st, out, (p, kw) in zip(streams, outs, reqs):
        check(st.finish_reason in ("eos", "length"),
              f"stream finished {st.finish_reason}")
        check(1 <= len(out) <= kw["max_new_tokens"], "bad stream length")
        check(all(0 <= t < VOCAB for t in out), "token outside the vocab")
    steps = rep["decode_dispatches"] - steps0
    prefills = sum(rep["prefill_dispatch_counts"].values()) - prefills0
    check(launches["paged_attention"] == LAYERS * steps,
          f"paged_attention launched {launches['paged_attention']} times, "
          f"want {LAYERS} per decode step x {steps}")
    check(launches["layer_norm"] == 2 * LAYERS * (steps + prefills),
          f"layer_norm launched {launches['layer_norm']} times, want "
          f"{2 * LAYERS} per step x {steps + prefills} steps")
    h = srv.metrics.snapshot()["histograms"]
    summary = {
        "serving": "paged", "params": n_params, "requests": len(reqs),
        "tokens_generated": rep["tokens_generated"],
        "decode_steps": steps, "prefills": prefills,
        "wall_s": wall, "tokens_per_s": rep["tokens_generated"] / wall,
        "decode_step_ms_mean": h["decode_step_ms"]["mean"],
        "decode_step_ms_p50": h["decode_step_ms"]["p50"],
        "decode_step_ms_p99": h["decode_step_ms"]["p99"],
        "prefill_ms_mean": h["prefill_ms"]["mean"],
        "finish": [s.finish_reason for s in streams],
        "launches": launches, "unaccounted": rep["unaccounted"],
        "kv_pages_owed": rep["kv_pages_owed"],
    }
    log(json.dumps(summary))
    return lm, eng, reqs, outs, launches, steps


# ---------------------------------------------------------------------------
# phase 4: reference checks


def plain_logits(lm, seq, dev):
    """The plain-version forward on the card: no cache, dense causal
    attention, plain LayerNorm; no hand-written kernel runs."""
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    before = (ln.fused_layer_norm.launches, pa.paged_attention.launches)
    with flags_guard(fused_layer_norm="never",
                     pallas_paged_attention="never"), torch.inference_mode():
        lg = lm(torch.tensor([seq], device=dev))[0].float()
    check((ln.fused_layer_norm.launches, pa.paged_attention.launches)
          == before, "the plain-version forward launched a kernel")
    return lg


def teacher_forced_check(lm, eng, prompt, served, dev):
    """Re-run ``prompt`` alone through the engine (kernel path) and
    compare each step's logits with the plain-version forward."""
    eng_logits = []
    toks = [eng.prefill(0, np.asarray(prompt, np.int32), 0.0, 0, 0)]
    eng_logits.append(eng.last_prefill_logits.clone())
    active = np.zeros([eng.slots], bool)
    active[0] = True
    for _ in range(len(served) - 1):
        t, _ = eng.decode(active)
        toks.append(int(t[0, 0]))
        eng_logits.append(eng.last_logits[0].clone())
    eng.release(0)
    check(toks == served, f"greedy request alone {toks[:8]}... != served "
          f"{served[:8]}...")
    seq = list(prompt) + served[:-1]
    ref = plain_logits(lm, seq, dev)[len(prompt) - 1:]
    got = torch.stack(eng_logits)
    err = float((got - ref).abs().max())
    check(err <= LOGIT_TOL, f"teacher-forced logits differ by {err} > "
          f"{LOGIT_TOL}")
    return err, len(served)


def dense_check(lm_state, dev):
    """Dense slot cache (``paged=False``) at depth 2: serve 4 requests,
    drain, and hold the greedy streams to the plain-version forward."""
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                           GenerationServer)
    lm = CausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, dim_feedforward=FFN,
                  num_layers=2, max_seq=MAX_SEQ)
    lm.load_state_dict({k: v for k, v in lm_state.items()
                        if not k.startswith("encoder.layers.")
                        or int(k.split(".")[2]) < 2})
    eng = GenerationEngine(lm, slots=SLOTS, max_seq=MAX_SEQ, eos_id=2,
                           paged=False)
    srv = GenerationServer(eng).start()
    rng = np.random.default_rng(SEED + 2)
    reqs = [(rng.integers(3, VOCAB, n).tolist(), kw) for n, kw in (
        (9, dict(max_new_tokens=24)),
        (70, dict(max_new_tokens=24, temperature=0.9, top_k=20, seed=5)),
        (130, dict(max_new_tokens=24)),
        (31, dict(max_new_tokens=24, temperature=0.7, seed=6)))]
    pa_before = pa.paged_attention.launches
    ln_before = ln.fused_layer_norm.launches
    outs = [s.result(timeout=300) for s in
            [srv.submit(p, **kw) for p, kw in reqs]]
    rep = srv.drain(timeout=300)
    torch.cuda.synchronize()
    check(rep["unaccounted"] == 0 and rep["tokens_owed"] == 0,
          f"dense drain report {rep}")
    check(ln.fused_layer_norm.launches > ln_before,
          "dense run did not launch the LayerNorm kernel")
    check(pa.paged_attention.launches == pa_before,
          "dense run launched the paged kernel")
    worst_gap = 0.0
    for (p, kw), out in zip(reqs, outs):
        if kw.get("temperature"):
            continue
        lg = plain_logits(lm, list(p) + out[:-1], dev)[len(p) - 1:]
        for i, tok in enumerate(out):
            gap = float(lg[i].max() - lg[i, tok])
            worst_gap = max(worst_gap, gap)
    check(worst_gap <= LOGIT_TOL, f"dense greedy token is {worst_gap} below"
          " the plain forward's argmax")
    return {"dense_depth": 2, "requests": len(reqs),
            "tokens": rep["tokens_generated"], "worst_argmax_gap": worst_gap}


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name in build.SOURCES:
        report = build.build_log(name) or ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernels = kernel_phase(dev)
    lm, eng, reqs, outs, launches, steps = serving_phase(dev)

    greedy = [i for i, (_, kw) in enumerate(reqs)
              if not kw.get("temperature")]
    pick = max(greedy, key=lambda i: len(outs[i]))
    err, n = teacher_forced_check(lm, eng, reqs[pick][0], outs[pick], dev)
    log(json.dumps({"teacher_forced": {"request": pick, "steps": n,
                                       "max_abs_logit_err": err}}))
    state = {k: v for k, v in lm.state_dict().items()}
    del eng
    log(json.dumps(dense_check(state, dev)))

    per_step = {"paged_attention": LAYERS, "layer_norm": 2 * LAYERS}
    replaces = {"paged_attention": "paddle1_tpu/ops/pallas/paged_attention.py:89",
                "layer_norm": "paddle1_tpu/ops/pallas/layer_norm.py:42"}
    line = []
    for name in ("paged_attention", "layer_norm"):
        main_case = kernels[name][0]     # the decode step's shape
        err = max(c["max_abs_err"] for c in kernels[name])
        line.append({
            "name": name, "route": "cuda",
            "source": f"paddle1_tpu_torch/ops/cuda/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err, "max_err": err,
            "ms": main_case["ms"], "us": main_case["ms"] * 1e3,
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "launches_per_decode_step": per_step[name],
            "decode_steps": steps, "cases": kernels[name],
            "bf16_check": kernels[name + "_bf16"]})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
