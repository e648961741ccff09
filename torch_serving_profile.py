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
  - the paged-attention kernel alone at this decode batch (CUDA events),
    with the kernel that ran it.
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
    engine = build_llama_engine(
        cfg, engine_config=RaggedInferenceEngineConfig(num_kv_blocks=kv_blocks),
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


if __name__ == "__main__":
    sys.exit(main())
