#!/usr/bin/env python3
"""Where a prefill chunk and a decode step of the deepspeed_tpu_torch
serving engine spend their time, on one CUDA GPU.

    python3 torch_serving_profile.py [bf16] [int8] [starcoder2] [bloom] [gemma2]

For each variant named (all five by default), one after the other: the
bf16 Llama-3-8B engine, the int8 one (``quantize="int8",
kv_cache_dtype="int8"``), StarCoder2-7B (``STARCODER2_7B`` through
``policy_for("starcoder2").config_from_hf``, window 4096), BLOOM-7B1
(``BLOOM_7B1`` through ``policy_for("bloom").config_from_hf``: ALiBi, MHA)
and Gemma-2-9B (``GEMMA2_9B`` through ``policy_for("gemma2")
.config_from_hf``: 42 layers, head_dim 256, K4's softcap, the window on
the even layers, K5's fp32-scale norms 4L+1 per step). Each builds
``build_llama_engine`` with seeded random bf16 weights and 8 GiB of
64-token KV blocks; feeds one sequence ``PREFILL_DEPTH`` tokens in chunks
of ``CHUNK``, traces its next chunk of ``CHUNK`` tokens (device time by
group as below, K4's multi-row wgmma tiles and its decode kernel apart
from its CUDA-core kernel and the split's merge, the busy share and the
chunk's tokens/s) and frees it; then
prefills ``SEQS`` sequences (Llama: 128, 256, ...
tokens; StarCoder2: 5120, 4608, 2048, ... 128 tokens, most of them past
the window; BLOOM: 2048, 1536, ... 128 tokens; Gemma-2: 5120, 4864, 4352,
... 128 tokens), then runs ``STEPS`` decode steps (one token per sequence
per ``put``):
  - step time on the host clock, each step ending in a device sync;
  - a ``torch.profiler`` trace of a few steps: each step's device ms, the
    device time per kernel name, summed into groups (K4 paged attention by
    kernel, K5 RMSNorm, K5b LayerNorm, the int8 weights' dequantize,
    matmuls, other), and the device's busy share of the traced wall time;
  - one fused decode window of ``WINDOW`` steps (``fused_decode_steps``:
    the captured step replayed), after a window that captured it, traced:
    its device ms per step and the device's busy share;
  - the host's ms per step of the per-step tick ``generate`` runs at window
    1 (``put``, the logits' copy, the host argmax), split into batch
    assembly (``RaggedBatchWrapper.finalize``), the kernel wrappers' own
    host time, the rest of the forward's launches, the wait for the
    device, the logits copy and sampling;
  - the paged-attention kernel alone at this decode batch (CUDA events),
    with the kernel that ran it;
  - ``generate_decode``: ``generate`` on the same prompts, all admitted in
    one prefill (the engine's batch budget holds them), ``NEW_TOKENS`` new
    tokens each, at windows 1 and 16 in turns (``ROUNDS`` rounds after one
    warm run of each): decode tokens/s on generate's wall time less its
    prefill forward's, and ms per token-step.
Prints one JSON line per part, each naming its variant, and exits non-zero
without a CUDA device.
"""

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 16  # timed decode steps
SEQS = 8    # live sequences, prompts of 128, 256, ..., 128 * SEQS tokens
CHUNK = 768  # tokens of a traced prefill chunk (the engine's batch budget)
PREFILL_DEPTH = 3072  # tokens in the cache before it
WINDOW = 16  # steps of a traced fused decode window
HOST_STEPS = 8  # per-step ticks whose host time is split
NEW_TOKENS = 33  # generate_decode: the prefill's token, then 32 decode steps
ROUNDS = 2  # generate_decode: timed rounds at each window
# variant -> (model, build options, prompt lengths, KV blocks of 8 GiB)
VARIANTS = {
    "bf16": ("llama3_8b", {}, [128 * (i + 1) for i in range(SEQS)], 1024),
    "int8": ("llama3_8b", {"quantize": "int8", "kv_cache_dtype": "int8"},
             [128 * (i + 1) for i in range(SEQS)], 1024),
    "starcoder2": ("starcoder2_7b", {}, [5120, 4608, 2048, 1024, 512, 256, 128, 128],
                   2048),
    "bloom": ("bloom_7b1", {}, [2048, 1536, 1024, 1024, 512, 256, 128, 128], 273),
    "gemma2": ("gemma2_9b", {}, [5120, 4864, 4352, 3072, 2048, 1024, 512, 128], 390),
}


def model_config(name: str):
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.module_inject import (BLOOM_7B1, GEMMA2_9B, STARCODER2_7B,
                                                   policy_for)
    if name == "gemma2_9b":
        return policy_for("gemma2").config_from_hf(GEMMA2_9B)
    if name == "starcoder2_7b":
        return policy_for("starcoder2").config_from_hf(STARCODER2_7B)
    if name == "bloom_7b1":
        return policy_for("bloom").config_from_hf(BLOOM_7B1)
    return LlamaConfig.llama3_8b()


def _group(name: str) -> str:
    n = name.lower()
    if "paged_attention_wgmma" in n:  # K4's multi-row tiles
        return "K4 paged_attention (wgmma tiles)"
    if "paged_decode" in n:  # K4's decode kernel
        return "K4 paged_attention (decode kernel)"
    if "paged_attention" in n or "dstt::combine" in n:  # K4 and its split merge
        return "K4 paged_attention"
    norm = re.search(r"row_norm(?:_scalar)?_kernel<(false|true|\(bool\)0|\(bool\)1)", n)
    if norm:  # csrc/row_norm.cuh, its first template argument LayerNorm's flag
        return "K5b layer_norm" if norm.group(1) in ("true", "(bool)1") else "K5 rms_norm"
    if "dequantize" in n:
        return "int8 weight dequantize"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "matmul")):
        return "matmul"
    return "other"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    names = sys.argv[1:] or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        print(f"torch_serving_profile: unknown variant(s) {unknown}; "
              f"choose from {list(VARIANTS)}", file=sys.stderr)
        return 2
    for variant in names:
        profile_variant(variant, *VARIANTS[variant], gpu)
        torch.cuda.empty_cache()
    return 0


def trace(fn, n: int) -> dict:
    """``n`` calls of ``fn`` under torch.profiler: wall and device ms per
    call, the device's busy share, device ms per group and the top
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only: a host op's row repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
    groups = {}
    for name, us in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_call": 1e3 * wall / n, "device_ms_per_call": busy_ms,
            "device_busy_share": busy_ms / (1e3 * wall / n),
            "group_ms_per_call": {k: v / 1e3 / n for k, v in groups.items()},
            "top_kernels_ms_per_call": [[k[:120], v / 1e3 / n] for k, v in top]}


def profile_variant(variant: str, model: str, build_kw: dict, prompt_lens: list,
                    kv_blocks: int, gpu: str) -> None:
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.models.llama import _layer_window
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention

    cfg = model_config(model)
    # a batch budget that admits every prompt in one prefill in generate_decode
    budget = max(768, sum(prompt_lens))
    engine = build_llama_engine(
        cfg, engine_config=RaggedInferenceEngineConfig(
            num_kv_blocks=kv_blocks, state_manager={"max_ragged_batch_size": budget}),
        seed=0, dtype=torch.bfloat16, kv_block_size=64, **build_kw)
    # a prefill chunk at depth: PREFILL_DEPTH tokens fed, the next CHUNK
    # traced (the earlier chunks ran the same kernels at the same bucket).
    # The wgmma count reads 0 on a tree whose K4 has no wgmma tiles.
    uid = 1 << 20
    chunked = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                PREFILL_DEPTH + CHUNK).tolist()
    for ofs in range(0, PREFILL_DEPTH, CHUNK):
        engine.put([uid], [chunked[ofs:ofs + CHUNK]], do_checks=False)
    torch.cuda.synchronize()
    wgmma = getattr(paged_attention, "wgmma_launches", 0)
    prefill = trace(lambda: engine.put([uid], [chunked[PREFILL_DEPTH:]], do_checks=False), 1)
    print(json.dumps({"part": "prefill_chunk", "variant": variant, "gpu": gpu,
                      "model": model, "seen": PREFILL_DEPTH, "chunk_tokens": CHUNK,
                      "layers": cfg.num_hidden_layers,
                      "k4_wgmma_launches": getattr(paged_attention, "wgmma_launches", 0) - wgmma,
                      "tokens_per_s": CHUNK / (prefill["wall_ms_per_call"] / 1e3),
                      **prefill}), flush=True)
    engine.flush(uid)
    rng = np.random.default_rng(0)
    uids = list(range(SEQS))
    for u in uids:  # prefill one sequence per put (<= 768 tokens per chunk)
        prompt = rng.integers(0, cfg.vocab_size, prompt_lens[u]).tolist()
        for ofs in range(0, len(prompt), 768):
            engine.put([u], [prompt[ofs:ofs + 768]], do_checks=False)
    torch.cuda.synchronize()

    def step():
        logits = engine.put(uids, [[1]] * len(uids))
        return logits.argmax(-1).cpu()  # the host needs the tokens

    for _ in range(3):
        step()
    times = []
    for _ in range(STEPS):
        t = time.monotonic()
        step()
        times.append(time.monotonic() - t)
    print(json.dumps({"part": "decode_steps", "variant": variant, "gpu": gpu,
                      "model": model, "seqs": SEQS,
                      "steps": STEPS, "step_ms": [1e3 * t for t in times],
                      "step_ms_mean": 1e3 * sum(times) / len(times),
                      "tokens_per_s": SEQS * len(times) / sum(times)}),
          flush=True)

    n_prof = 4
    decode = trace(step, n_prof)
    print(json.dumps({
        "part": "profile", "variant": variant, "gpu": gpu, "steps": n_prof,
        "wall_ms_per_step": decode["wall_ms_per_call"],
        "device_ms_per_step": decode["device_ms_per_call"],
        "device_busy_share": decode["device_busy_share"],
        "group_ms_per_step": decode["group_ms_per_call"],
        "top_kernels_ms_per_step": decode["top_kernels_ms_per_call"]}), flush=True)

    # one window of WINDOW steps, its step graph captured by the window before
    toks = [1] * len(uids)
    engine.fused_decode_steps(uids, toks, WINDOW)
    window = trace(lambda: engine.fused_decode_steps(uids, toks, WINDOW), 1)
    print(json.dumps({
        "part": "window_profile", "variant": variant, "gpu": gpu, "seqs": len(uids),
        "window_steps": WINDOW, "graphs": len(engine.model()._graphs),
        "graph_pool_bytes": engine.model().graph_pool_bytes,
        "wall_ms_per_step": window["wall_ms_per_call"] / WINDOW,
        "device_ms_per_step": window["device_ms_per_call"] / WINDOW,
        "device_busy_share": window["device_busy_share"],
        "group_ms_per_step": {k: v / WINDOW for k, v in window["group_ms_per_call"].items()},
        "top_kernels_ms_per_step": [[k, v / WINDOW]
                                    for k, v in window["top_kernels_ms_per_call"]]}),
          flush=True)
    print(json.dumps({"part": "host_split_k1", "variant": variant, "gpu": gpu,
                      "seqs": len(uids), "steps": HOST_STEPS,
                      **host_split(engine, uids)}), flush=True)

    # K4 alone at this decode batch, on the engine's own cache and tables
    # (layer 5: global on Gemma-2, which windows the even layers)
    sm = engine._state_manager
    seqs = [sm.get_sequence(u) for u in uids]
    B = max(s.cur_allocated_blocks for s in seqs)
    bt = torch.tensor(np.stack([s.block_table(B) for s in seqs]),
                      dtype=torch.int32, device="cuda")
    seen = torch.tensor([s.seen_tokens - 1 for s in seqs], dtype=torch.int32,
                        device="cuda")
    lens = seen + 1
    q = torch.randn(len(uids), 1, cfg.num_attention_heads, cfg.head_dim_,
                    device="cuda", dtype=torch.bfloat16)
    cache = sm.kv_cache.cache
    cache, scales = cache if isinstance(cache, tuple) else (cache, None)
    window = _layer_window(cfg, 5)

    alibi = cfg.pos_embedding == "alibi"  # BLOOM

    def k4():
        paged_attention(q, cache, 5, bt, seen, lens, page_size=64, window=window,
                        cache_scales=scales, use_alibi=alibi,
                        softcap=cfg.attn_logit_softcapping)

    # the kernel that runs it, by the wrapper's counters (a tree without a
    # decode kernel reads 0 for it)
    counts = [getattr(paged_attention, c, 0) for c in ("wgmma_launches", "decode_launches")]
    k4()
    ran = [getattr(paged_attention, c, 0) - n
           for c, n in zip(("wgmma_launches", "decode_launches"), counts)]
    kernel = "wgmma" if ran[0] else "decode" if ran[1] else "cuda cores"
    for _ in range(2):
        k4()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        k4()
    end.record()
    end.synchronize()
    # K and V of each visible token and head: D bf16 values, or D int8
    # codes and a 4-byte scale; with a window, at most the window's keys
    hd = cfg.head_dim_
    per_head = hd + 4 if scales is not None else 2 * hd
    visible = lens.clamp(max=window) if window else lens
    kv_bytes = int(visible.sum()) * cfg.num_key_value_heads * per_head * 2
    print(json.dumps({"part": "k4_decode", "variant": variant, "gpu": gpu,
                      "seqs": len(uids), "history": [int(x) for x in lens.tolist()],
                      "window": window, "alibi": alibi,
                      "softcap": cfg.attn_logit_softcapping, "kernel": kernel,
                      "ms": start.elapsed_time(end) / 50,
                      "bound_ms": kv_bytes / 3.35e12 * 1e3}), flush=True)

    for u in uids:
        engine.flush(u)
    print(json.dumps({"part": "generate_decode", "variant": variant, "gpu": gpu,
                      **generate_decode(engine, cfg, prompt_lens)}), flush=True)


def host_split(engine, uids) -> dict:
    """The host's ms per step of ``HOST_STEPS`` per-step greedy ticks as
    ``generate`` runs them at window 1: ``put`` (batch assembly, then the
    forward's launches, the kernel wrappers' share of them timed inside
    the wrappers), the wait for the device, the copy of the logits rows to
    the host and the float64 argmax of each row."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import model as ragged_model
    spent = {"finalize": 0.0, "wrappers": 0.0}

    def timed(fn, key):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        return wrapper

    wrapped = ("paged_attention", "rms_norm", "layer_norm")
    saved = {name: getattr(ragged_model, name) for name in wrapped}
    finalize = engine._batch.finalize
    for name in wrapped:
        setattr(ragged_model, name, timed(saved[name], "wrappers"))
    engine._batch.finalize = timed(finalize, "finalize")
    dq = ragged_model.QuantizedParameter.dequantized
    ragged_model.QuantizedParameter.dequantized = timed(dq, "wrappers")
    parts = {"put": 0.0, "device_wait": 0.0, "logits_copy": 0.0, "sampling": 0.0}
    toks = [1] * len(uids)
    try:
        for _ in range(HOST_STEPS):
            t0 = time.perf_counter()
            logits = engine.put(uids, [[t] for t in toks])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rows = logits[:len(uids)].detach().float().cpu().numpy()
            t3 = time.perf_counter()
            toks = [int(np.argmax(r.astype(np.float64))) for r in rows]
            t4 = time.perf_counter()
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[key] += dt
    finally:
        for name in wrapped:
            setattr(ragged_model, name, saved[name])
        engine._batch.finalize = finalize
        ragged_model.QuantizedParameter.dequantized = dq
    ms = {k: 1e3 * v / HOST_STEPS for k, v in {**parts, **spent}.items()}
    return {"ms_per_step": {
        "batch_assembly": ms["finalize"], "kernel_wrappers": ms["wrappers"],
        "other_forward_launches": ms["put"] - ms["finalize"] - ms["wrappers"],
        "device_wait": ms["device_wait"], "logits_copy": ms["logits_copy"],
        "sampling": ms["sampling"]},
        "total_ms_per_step": sum(ms[k] for k in parts)}


def generate_decode(engine, cfg, prompt_lens) -> dict:
    """``generate`` at windows 1 and 16 in turns on one wave of prompts:
    decode tokens/s on the wall time less the prefill forward's (timed
    with a device sync around it), ms per token-step, and the windows."""
    import numpy as np
    import torch
    model = engine.model()
    inner = model.forward
    prefill = []

    def forward(batch, **kw):
        if batch.q_tok_idx.shape[1] == 1:
            return inner(batch, **kw)
        torch.cuda.synchronize()
        t = time.monotonic()
        out = inner(batch, **kw)
        torch.cuda.synchronize()
        prefill.append(time.monotonic() - t)
        return out

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    model.forward = forward
    runs = {1: [], 16: []}
    try:
        for i, K in enumerate([1, 16] + [1, 16] * ROUNDS):
            prefill.clear()
            torch.cuda.synchronize()
            t = time.monotonic()
            out = engine.generate(prompts, max_new_tokens=NEW_TOKENS, fused_decode_window=K)
            torch.cuda.synchronize()
            wall = time.monotonic() - t
            if i < 2:  # the warm runs: first launches, graph captures
                continue
            steps = NEW_TOKENS - 1
            decode_s = wall - sum(prefill)
            runs[K].append({"generate_s": wall, "prefill_forward_s": sum(prefill),
                            "decode_tokens_per_s": len(prompts) * steps / decode_s,
                            "ms_per_token_step": 1e3 * decode_s / steps,
                            "outputs_equal_k1": None})
            if K == 1:
                ref = out
            else:
                runs[K][-1]["outputs_equal_k1"] = out == ref
    finally:
        model.forward = inner
    return {"seqs": len(prompts), "prompt_lens": list(prompt_lens), "new_tokens": NEW_TOKENS,
            "k1": runs[1], "k16": runs[16], "graphs": len(model._graphs),
            "graph_pool_bytes": model.graph_pool_bytes}


if __name__ == "__main__":
    sys.exit(main())
