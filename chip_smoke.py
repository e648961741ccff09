#!/usr/bin/env python3
"""Smoke run of the deepspeed_tpu_torch serving (bf16 and int8; Llama,
StarCoder2, BLOOM, Gemma-2) and training paths (bf16 and fp16, each
optimizer K7 runs, Mistral-7B's windowed attention through both kernel
layouts, Gemma-2 at head_dim 256 with its softcaps) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build          — compile the CUDA kernels from deepspeed_tpu_torch/csrc
                      with nvcc (sm_90a, one process per source) and load
                      them; report versions, the GPU, each source's
                      seconds, ptxas's registers and spill bytes of the
                      flash kernels' head-width-256 instances, and of each
                      wgmma instance (K1's forward and K2's dq and dk/dv in
                      bf16 and fp16 at head widths 128 and 256; K4's
                      multi-row tiles over a bf16 and an int8 cache) its
                      registers, spills, dynamic shared memory and any
                      ptxas warning that its products are serialized; the
                      same (but the warnings) for each instance of K4's
                      decode kernel; registers and spills of K5/K5b's
                      row-norm instances and of K6's kernels.
  2. kernels        — every kernel of both paths against its plain PyTorch
                      version at main-path shapes in bf16: the error
                      beside the stated tolerance (flash: row by row, with
                      the exact fp64 value as a control), kernel / plain / library
                      time and the least time the card could take (bound).
                      Large cases are timed with CUDA events around 20
                      calls; the small ones (K5, K5b, K6, K4 decode) by
                      replaying 20 calls captured in a CUDA graph, so the
                      time is the device's and not the wrapper's host
                      cost; an empty kernel's graph time (the card's floor
                      for one launch) beside the norms. K6 and the
                      dequantize helper must equal their plain versions bit
                      for bit; K4 is held row by row against one bf16
                      rounding of the exact fp32 output on the same inputs,
                      and each K4 case records which kernel ran it (the
                      multi-row wgmma tiles from the plan's folded rows N * G
                      per sequence and KV head, else the decode kernel; every
                      decode step, over both caches, in the decode
                      kernel), checked against that rule, and the tiles'
                      crossover against the decode kernel is swept at 8
                      to 64 folded rows (BLOOM's G 1, Gemma-2's G 2,
                      Llama's G 4, StarCoder2's G 9), graph-timed, each
                      launch held as the cases are; fp32 queries run the
                      CUDA-core kernel (Gemma-2's decode over an fp32
                      cache, as its fp32 engine runs it, and Llama's over
                      int8, held to the plain version that follows its
                      page split with P rounded);
                      beside the admission
                      wave, a 100-token chunk next to a padding sequence
                      and a decode row, and phase 7's 768-token chunk deep
                      in an int8 cache.
                      K5b and K4 with StarCoder2's sliding window (freed
                      table entries included) at that model's widths.
                      K1/K2's fp16 instance at the training shape, row by
                      row as the bf16 cases. K1/K2 with Mistral's window
                      at its S 8192 (and without it, for what the window
                      saves) and with softcap 50 at the training shape;
                      K3 (the folded layout) at the training shape, the
                      Mistral shape and with the softcap (SDPA with a
                      boolean mask is the window's library time;
                      flex_attention with the cap as its score_mod the
                      softcap's). K7's bodies
                      (AdamW, Adam with L2, Lion, LAMB's first pass) at
                      one Llama-3-8B layer's parameters (218,112,000) and
                      at a ragged
                      12,391, and the whole LAMB step over that layer's 9
                      tensors, each output within 2 fp32 ulps of the plain
                      version; torch.optim's fused Adam/AdamW step beside
                      the Adam rows. Gemma-2-9B's widths (H 16, KV 8, D
                      256, caps 50, queries scaled so that about a fifth
                      of the scaled scores pass cap / 2, each case
                      recording that share): K4's softcap instance at
                      decode through the page split (without and with
                      the 4096 window, bf16 and int8 caches) and on a
                      768-row chunk straddling the window's edge; K1/K2
                      at S 8192 (window 4096, and causal alone; fp16 at
                      the window's shape) and K3 at the window's shape,
                      flex_attention with the cap as its score_mod the
                      library time, SDPA without the cap beside it; the
                      other D-256 instances (per-head fp32, folded fp16
                      and fp32) at S 2048 under a 512 window, with
                      flex_attention in their dtype the library time; K5's
                      fp32-scale instance at [8, 3584] and [768, 3584].
  3. parity         — the tiny Llama config in fp32 through the whole serving
                      engine on the GPU (kernels) and on the CPU (plain
                      versions), same weights: logits must agree; then the
                      same with int8 weights and an int8 KV cache.
  4. train_parity   — the tiny config in fp32, the same with a 48-token
                      window and softcap 30, and a tiny Gemma-2 (head_dim
                      256: the fp32 D-256 instances; window on layer 0),
                      same weights, 3 AdamW steps (clipping, WarmupLR) of
                      the training engine on the GPU and on the CPU:
                      losses and parameters must agree.
  5. training       — initialize() at the Llama-3-8B width cut to 4 layers
                      (seeded random bf16 weights, flat fp32 masters and
                      AdamW state, chunked CE), 6 forward/backward/step on
                      one repeated batch of 2 x 2048 tokens; checks finite
                      and falling losses, L launches per step of each flash
                      kernel and one K7 launch per step, and holds the
                      last step's K7 launch against the plain version over
                      the whole flat buffer (1.923e9 elements, within 2
                      fp32 ulps); reports step time, tokens/s, peak memory
                      and the model-FLOP share; then, after the counts are
                      read, two more steps: one split into forward,
                      backward and optimizer step, one traced by
                      torch.profiler and summed by kernel group (K7's time
                      inside the optimizer step); last, K7 and
                      torch.optim's fused AdamW timed on the engine's flat
                      state.
  5b. training_optimizers — the same model and batch with Lion (bf16, 3
                      steps), LAMB (bf16, weight decay 0.01, 3 steps) and
                      AdamW in fp16 with dynamic loss scaling (6 steps, an
                      inf injected into steps 3 and 5's gradients): losses, step
                      and optimizer-step ms, one K7 launch per step (K7
                      reads the overflow flag on the card and writes
                      nothing on a skipped step), the last step's K7 launch held
                      against the plain version over the whole flat buffer
                      as in phase 5; for fp16 the skipped steps keep the
                      flat state's fingerprints, the scale follows
                      update_scale replayed on the overflow flags, and the
                      fp16 flash instances run L times per step.
  5c. training_mistral — Mistral-7B-v0.1's published widths from
                      policy_for("mistral").config_from_hf(MISTRAL_7B), cut
                      to 4 layers, one 8192-token sequence, bf16, AdamW
                      (K7), 6 steps, twice from the same weights: the route
                      as resolved (K1/K2, each 4 per step) and pinned to
                      folded by DS_TPU_ATTN_FWD/BWD (K3, each 4 per step);
                      losses of the two runs agree at every step; step
                      ms, tokens/s, model-FLOP share, peak memory and a
                      profiled step per run.
  5d. training_gemma2 — google/gemma-2-9b's published widths from
                      policy_for("gemma2").config_from_hf(GEMMA2_9B), cut
                      to 4 layers (windows on layers 0 and 2), one
                      8192-token sequence, bf16, AdamW (K7), the chunked
                      CE with the final softcap, 6 steps: K1/K2 at head_dim
                      256 with the softcap 4 times per step each, finite
                      falling losses, step ms, tokens/s, model-FLOP share,
                      peak memory and a profiled step.
  5e. training_fused — the rest of the training engine at the Llama-3-8B
                      width cut to 2 layers (bf16, AdamW + WarmupLR + clip
                      1.0, chunked CE): two windows of fused_train_steps
                      (K 4, 1 x 4096 tokens), the first under
                      set_sync_debug_mode("error") with its one fetch
                      outside, bit-equal to 8 forward/backward/step from
                      the same weights; ms per step of a window and of
                      the sequential path and each one's device busy share
                      over 4 steps (torch.profiler, device activity only;
                      the sequential steps read each loss); the same in
                      fp16 from a scale of
                      2^24 (skipped steps, scale, LR, masters equal);
                      gas-2 train_batch bit-equal to its micro loop; a
                      bf16 accumulation buffer (half the bytes, losses
                      within 5e-3); remat off / nothing_saveable /
                      dots_saveable at 1 x 8192 (step ms, peak memory, K1
                      2L a step under remat, losses and flat gradient
                      bit-equal); K7 in its device-scalar form over the
                      whole flat buffer within K7_ULPS of the plain
                      version, and a set skip flag leaving the state.
  5f. training_zero — ZeRO 1-3 over the named mesh at the Llama-3-8B width
                      cut to 2 layers (bf16, AdamW, no clipping, chunked
                      CE, dots_saveable remat; 3 steps then a 2-step
                      window, dryrun_multichip's order): (a) world 1 over
                      NCCL in this process, stages 1-3 bit-equal to stage
                      0 after every step, each window under
                      set_sync_debug_mode("error"); (b) two ranks spawned
                      on the one card over gloo (NCCL on two cards where
                      there are two): stage 0 over {data: 2} and stage 2
                      over {data: 2} one step each, stage 3 over {fsdp:
                      2} two, against (a)'s stage 0 within
                      tests/test_torch_zero.py's bf16 tolerance, each
                      rank's flat state half of stage 0's plus padding,
                      K7 once per step per rank and rank 1's stage-3
                      launch held against the plain version at its
                      shard's length; peak memory and step times (gloo on
                      one card, not a speed of NCCL).
  5g. training_grad_comm — the bucketed gradient wire, the 1-bit
                      optimizers' wire and muP on the same model at gas 2
                      (see the phase's docstring).
  5h. training_zero3_scheduled — the scheduled ZeRO-3 store on the same
                      model without remat at gas 2: (a) world 1 over NCCL,
                      bit-equal to the stage-2 wire every step, its
                      schedule's epochs, prefetches, gathered peak and
                      wire bytes, the int8 tiers within 0.05, K7 on the
                      store's shard and K1/K2 at the path's shape held
                      against their plain versions; (b) two gloo ranks on
                      the card at half the store each, one step (state
                      bytes, peak GiB, rank 1's K7 on its half).
  5i. training_checkpoint — save, verify, corrupt the newest tag and fall
                      back, resume bit-equal to an uninterrupted run,
                      load into stage 2, write a universal directory;
                      each save's, verify's and load's bytes
                      and seconds, in a temporary directory under build/
                      that the phase deletes.
  6. serving        — build_llama_engine at the full Llama-3-8B width (32
                      layers, seeded random bf16 weights, 1024 KV blocks of
                      64 tokens), greedy generate on 8 prompts of 128..1024
                      tokens with 32 new tokens each; checks outputs, finite
                      logits, kernel launch counts per forward (K4's wgmma
                      tiles L times in every prefill forward and never in
                      decode, its decode kernel L times in every decode
                      forward, its CUDA-core kernel never, in this and
                      every serving phase below), and prefill-vs-decode
                      consistency. generate runs the fused decode window
                      at its default, 16 (captured CUDA-graph steps):
                      each window K·L launches of K4's decode kernel and K
                      times the norms of a forward, nothing else of K4;
                      then, in every serving phase, the prompts again at
                      window 1, and cut to one admission wave at windows
                      16 and 1 (equal greedy streams; here also a sampled
                      run, equal tokens and logprobs within 1e-5); each
                      run's decode tokens/s and the graphs' pool bytes.
  7. serving_int8   — the same weights, prompts and KV byte budget through
                      build_llama_engine(quantize="int8",
                      kv_cache_dtype="int8") (K6 at build, the dequantize
                      helper at each use, K4 over the int8 cache): the same
                      checks, K6 launched 7 per layer (its device time over
                      the build: each shape it took graph-timed, times its
                      launches, beside the bound), the layer weights and
                      the memory after build at least 6 GiB below phase 6's,
                      and each prompt's prefill logits within cosine 0.99 of
                      phase 6's.
  8. serving_starcoder2 — StarCoder2-7B at its published widths (32 layers,
                      hidden 4608, 36/4 heads, window 4096, tied
                      embeddings) from policy_for("starcoder2")
                      .config_from_hf(STARCODER2_7B) with seeded random
                      bf16 weights, 2048 KV blocks of 64 tokens (8 GiB);
                      greedy generate on 8 prompts of 128..5120 tokens, 64
                      new tokens each. Checks K5b (LayerNorm) 2L+1 and K4
                      (windowed) L launches per forward, the live blocks of
                      every sequence after every put against the window
                      rule, free blocks back to the total after the
                      flushes, the 5120-token prompt's prefill logits
                      within cosine 0.999 of a plain fp32 forward on the
                      card (and that forward without the window or the
                      biases outside it), and prefill against decode past
                      the window.
  serving_gemma2   — Gemma-2-9B at its published widths and depth (42
                      layers) with seeded random bf16 weights (norm deltas
                      N(0, 0.1), q/k and the embedding drawn wide enough
                      that both caps bite), 390 KV blocks of 64 (8 GiB), 8
                      prompts of 128..5120 tokens (four past the window),
                      32 new tokens each: K4's softcap instance L and K5's
                      fp32-scale instance 4L+1 times per forward, no KV
                      block freed while the odd layers attend globally,
                      the 5120-token prompt's prefill logits and its last
                      token's decode step within cosine 0.999 of a plain
                      fp32 forward (and of each other) and five controls
                      (no attention cap, no final cap, no post norms, no
                      embedding scale, a window on every layer) outside
                      it; then the fp32 engine at the weights as first
                      drawn on that prompt, prefill and decode within
                      cosine 0.9999 of the plain fp32 forward.
  serving_speculative — Llama-3-8B at its 32 layers with prefix caching on
                      (64-token blocks in the serving KV budget): (a) eight
                      prompts sharing a 2048-token prefix (tails of 64-200
                      tokens, one diverging mid-block in another's tail)
                      put cold and then adopting: tokens fed, adopted
                      blocks, forks, first-token ms, adopted logits within
                      the serving phase's prefill-against-decode bound,
                      block conservation; (b) eight prompts of a repeated
                      64-token pattern, 64 new tokens, d 4, n-gram 2: plain
                      greedy at window 16, the per-token verify and the
                      fused speculative window at 16, equal streams or
                      each divergence explained by the logit margin against
                      the two forwards' difference there, K4's plans
                      beside it; a sampled pair (temperature 0.8, top-p
                      0.95, d 3), fused against per-token, equal; drafted
                      and accepted counts, decode tokens/s of a first and a
                      warm run, captures and pool bytes; (c) score against
                      a cold window put's
                      log-softmax. Phase 2 holds K4 at the verify windows'
                      shapes (N 5 and 3, each kernel) and an adopting
                      put's (8 tails of 128 over 32 shared pages).
  9. attn_sweep     — python -m deepspeed_tpu_torch.ops.attn_sweep's
                      sweep_shape once at the Mistral shape: each leg's
                      K1/K2 and K3 times and the winners, committed to
                      this run's cache; nothing after it reads them.
Each main path (phases 5, 5b-5i, 6, 7, 8, serving_speculative and the
BLOOM and Gemma-2 serving phases) runs with the launch counts of
its kernels set to 0 just before and read just after. Every phase resolves
the attention route against an empty cache directory made under build/
(DS_TPU_ATTN_CACHE_DIR), and each training phase prints its decisions
(kernel_dispatch.describe) and checks that both legs run kernels and that
a profiled step's K1 time is the wgmma forward's. Then
each phase's seconds, a ``{"kernels": [...]}`` line, the GPU's name and power limit, and, as the
last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero before that line. Without a
CUDA device it exits 2 and prints no result.
"""

import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_identity() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` from replaying a CUDA graph that holds
    ``iters`` back-to-back calls: what the card spends, without the
    wrapper's host cost between launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def free_memory() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_build() -> dict:
    import torch
    from deepspeed_tpu_torch.ops import _build
    t0 = time.monotonic()
    path = _build.build()
    _build.lib()
    seconds = time.monotonic() - t0
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    rec = {"phase": "build", "seconds": seconds, "library": os.path.relpath(path, ROOT),
           "attn_cache": os.path.relpath(os.environ["DS_TPU_ATTN_CACHE_DIR"], ROOT),
           "torch": torch.__version__, "torch_cuda": torch.version.cuda,
           "nvcc": nvcc.splitlines()[-1], "gpu": gpu_identity(),
           # ptxas's registers and spill bytes of the flash kernels'
           # head-width-256 instances
           "d256_resource_usage": _build.resource_usage("Li256E"),
           "wgmma_kernels": wgmma_usage(), "decode_kernels": decode_usage(),
           "f32_kernels": f32_usage(), "splash_kernels": splash_usage(),
           # K5/K5b's row-norm instances and K6's quantize kernels
           "row_norm_kernels": _build.resource_usage("row_norm"),
           "quantize_kernels": _build.resource_usage("quantize")}
    emit(rec)
    return rec


def splash_usage() -> list:
    """K8's grouped sweeps (the forward, dq and dk/dv in bf16, fp16 and
    fp32 at blocks 16-128 and head widths 64 and 128): ptxas's registers
    and spill bytes and the dynamic shared memory each launch asks for
    before its item's entries."""
    import re
    from deepspeed_tpu_torch.ops import _build
    passes = ("fwd", "dq", "dkdv")
    codes = {"float": 0, "f": 0, "__nv_bfloat16": 1, "13__nv_bfloat16": 1, "__half": 3,
             "6__half": 3}
    out = []
    for e in _build.resource_usage("grouped_kernel"):
        # demangled, or mangled where cu++filt is missing
        m = (re.search(r"(fwd|dq|dkdv)_grouped_kernel<(float|__nv_bfloat16|__half), "
                       r"\(int\)(\d+), \(int\)(\d+)>", e["kernel"])
             or re.search(r"(fwd|dq|dkdv)_grouped_kernelI(f|13__nv_bfloat16|6__half)"
                          r"Li(\d+)ELi(\d+)E", e["kernel"]))
        if m is None:
            out.append(e)
            continue
        kind, dtype, block, dmax = m.group(1), m.group(2), int(m.group(3)), int(m.group(4))
        out.append({**e, "pass": kind, "dtype": dtype.lstrip("0123456789"), "block": block,
                    "dmax": dmax, "dynamic_smem_bytes": _build.lib().dstt_splash_smem(
                        passes.index(kind), codes[dtype], dmax)})
    return out


def f32_usage() -> list:
    """K4's fp32-query instances (the chunk and decode kernels over an fp32
    and an int8 cache, head widths 128 and 256, with and without ALiBi and
    the softcap): ptxas's registers and spill bytes and the dynamic shared
    memory each launch asks for."""
    import re
    from deepspeed_tpu_torch.ops import _build
    out = []
    for e in _build.resource_usage("paged_f32"):
        name = e["kernel"]  # demangled, or mangled where cu++filt is missing
        ints = [int(x) for x in (re.findall(r"\(int\)(\d+)", name)
                                 or re.findall(r"Li(\d+)E", name))]
        int8 = "signed char" in name or "IaL" in name
        chunk = "chunk" in name
        out.append({**e, "dynamic_smem_bytes": _build.lib().dstt_paged_f32_smem(
            ints[0], int(int8), int(chunk), 0 if chunk else ints[1])})
    return out


def decode_usage() -> list:
    """K4's decode kernel instances (bf16 and int8 caches, head widths 64,
    128 and 256, with and without ALiBi and the softcap): ptxas's registers
    and spill bytes and the dynamic shared memory each launch asks for."""
    import re
    from deepspeed_tpu_torch.ops import _build
    out = []
    for e in _build.resource_usage("paged_decode_kernel"):
        name = e["kernel"]  # demangled, or mangled where cu++filt is missing
        dmax = int((re.search(r"\(int\)(\d+)", name) or re.search(r"Li(\d+)E", name)).group(1))
        int8 = "signed char" in name or "IaL" in name
        out.append({**e, "dynamic_smem_bytes": _build.lib().dstt_paged_decode_smem(dmax,
                                                                                  int(int8))})
    return out


def wgmma_usage() -> list:
    """The wgmma instances (K1's forward, K2's dq and dk/dv, bf16 and fp16,
    head widths 128 and 256, with and without the softcap; K4's multi-row
    tiles over a bf16 and an int8 cache, with and without ALiBi and the
    softcap): ptxas's registers and spill bytes, the dynamic shared memory
    each launch asks for, and ptxas's warnings that an instance's products
    are serialized."""
    from deepspeed_tpu_torch.ops import _build
    log = (_build.library_path().parent / _build.RESOURCE_LOG).read_text()
    serialized = [line.strip() for line in log.splitlines() if "wgmma" in line
                  and "serialized" in line]
    out = []
    for e in _build.resource_usage("wgmma"):
        name = e["kernel"]
        # demangled, or mangled where cu++filt is missing
        dmax = 256 if "256" in name else 128
        family = next(f for f in ("paged_attention_wgmma", "fwd_wgmma", "dq_wgmma",
                                  "dkdv_wgmma") if f in name)
        if family == "paged_attention_wgmma":
            int8 = "signed char" in name or "IaL" in name
            smem = _build.lib().dstt_paged_wgmma_smem(dmax, int(int8))
        else:
            cap = int("(bool)1" in name or "Lb1E" in name)
            smem = _build.lib().dstt_flash_wgmma_smem(
                ("fwd_wgmma", "dq_wgmma", "dkdv_wgmma").index(family), dmax, cap)
        out.append({**e, "dynamic_smem_bytes": smem,
                    "serialized_warnings": [w for w in serialized if family in w]})
    return out


def d256_usage(build: dict, wrapper: str, dtype: str) -> list:
    """ptxas's report for one flash pass at head width 256 (``wrapper``:
    e.g. ``flash_attention_bwd_dq``, ``folded_attention_fwd``) in ``dtype``,
    both softcap instances."""
    part = wrapper.split("_attention_")[1]
    # K3 launches K1/K2's kernels; bf16 and fp16 passes are wgmma's
    kernel = {"fwd": "fwd_kernel", "bwd_dq": "dq_kernel", "bwd_dkdv": "dkdv_kernel"}[part]
    if dtype != "float32":
        kernel = kernel.replace("_kernel", "_wgmma_kernel")
    ctype = {"bfloat16": "__nv_bfloat16", "float16": "__half", "float32": "float"}[dtype]
    return [e for e in build["d256_resource_usage"]
            if f"::{kernel}<{ctype}," in e["kernel"]]


def _rms_case(rows: int, d: int, gen, fp32_scale: bool = False) -> dict:
    """K5 on bf16 rows with a bf16 weight 1 + N(0, 0.1), or (``fp32_scale``,
    Gemma's serving norm) with the fp32 scale 1 + w, w ~ N(0, 1e-3)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.normalization import rms_norm, rms_norm_reference
    eps = 1e-6 if fp32_scale else 1e-5
    x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    if fp32_scale:
        w = 1.0 + 1e-3 * torch.randn(d, generator=gen, device="cuda")
    else:
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
    y = rms_norm(x, w, eps)
    ref = rms_norm_reference(x, w, eps)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
    return {"shape": [rows, d], "max_abs_err": err, "timing": "cuda graph",
            "ms": graph_time_ms(lambda: rms_norm(x, w, eps)),
            "plain_ms": graph_time_ms(lambda: rms_norm_reference(x, w, eps)),
            "library_ms": graph_time_ms(lambda: F.rms_norm(x, (d, ), w, eps)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def _ln_case(rows: int, d: int, gen, dtype) -> dict:
    """K5b on ``[rows, d]`` rows of N(0, 1) plus a per-row mean up to 3,
    weight 1 + N(0, 0.1), bias N(0, 0.1), all in ``dtype``."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.normalization import layer_norm, layer_norm_reference
    eps = 1e-5
    x = (torch.randn(rows, d, generator=gen, device="cuda")
         + 3 * torch.rand(rows, 1, generator=gen, device="cuda")).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    y = layer_norm(x, w, b, eps)
    ref = layer_norm_reference(x, w, b, eps)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    nbytes = 2 * rows * d * x.element_size() + 2 * d * w.element_size()
    return {"shape": [rows, d], "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tolerance": LN_TOL[str(dtype)], "timing": "cuda graph",
            "ms": graph_time_ms(lambda: layer_norm(x, w, b, eps)),
            "plain_ms": graph_time_ms(lambda: layer_norm_reference(x, w, b, eps)),
            "library_ms": graph_time_ms(lambda: F.layer_norm(x, (d, ), w, b, eps)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def launch_floor_ms() -> float:
    """Graph time of an empty kernel (csrc/rms_norm.cu dstt_empty_launch):
    the card's floor for one launch, a note beside the decode-row norms."""
    import torch
    from deepspeed_tpu_torch.ops import _build
    lib = _build.lib()
    return graph_time_ms(lambda: lib.dstt_empty_launch(torch.cuda.current_stream().cuda_stream))


def int8_kv(cache, D: int):
    """``cache`` as the int8 engine stores it: one scale per (row, slot,
    head) vector of D, max(absmax / 127, 1e-8), codes round(x / scale)."""
    from deepspeed_tpu_torch.inference.v2.model import quantize_kv
    L2, slots, KVD = cache.shape
    codes, sc = quantize_kv(cache.reshape(L2, slots, KVD // D, D))
    return codes.reshape(L2, slots, KVD), sc


def staged_kv(codes, scales, D: int):
    """What K4 stages from an int8 cache, the TPU kernel's numerics: each
    scale rounded to bf16, each product rounded to bf16."""
    L2, slots, KVD = codes.shape
    x = codes.float().reshape(L2, slots, KVD // D, D) * scales.bfloat16().float()[..., None]
    return x.bfloat16().reshape(L2, slots, KVD)


# K4's widths: Llama-3-8B's 32-layer cache (KV 8, G 4, D 128), and
# StarCoder2-7B's (KV 4, G 9, D 128; 4 layers of cache, enough pages for
# 8 sequences of 126 pages), both with 64-token pages
LLAMA_PAGED = dict(L=32, KV=8, G=4, D=128, ps=64, n_pages=160, layer=17)
SC2_PAGED = dict(L=4, KV=4, G=9, D=128, ps=64, n_pages=1009, layer=3)
SC2_WINDOW = 4096
# BLOOM-7B1's (MHA: KV 32, G 1, D 128; 4 layers of cache, pages for the
# serving phase's 8 sequences of up to 2048 + 32 tokens)
BLOOM_PAGED = dict(L=4, KV=32, G=1, D=128, ps=64, n_pages=300, layer=3)
# Gemma-2-9B's (KV 8, G 2, D 256; 4 layers of cache, pages for 8 sequences
# of up to 5120 + 32 tokens), its window and caps, and the query scale that
# makes the attention cap bite on N(0, 1) keys: scaled scores ~ N(0, 20^2),
# about a fifth of them past cap / 2. (At 40, half of them, P is nearly one
# key per row, and the plain version's own dq reads 0.024 from the exact
# value, past the row tolerance against it.)
GEMMA2_PAGED = dict(L=4, KV=8, G=2, D=256, ps=64, n_pages=700, layer=3)
GEMMA2_WINDOW, GEMMA2_ATTN_CAP = 4096, 50.0
CAP_Q_SCALE = 20.0


def _paged_inputs(gen, seen: list, n_new: list, N: int, B: int, int8: bool = False,
                  widths=LLAMA_PAGED, window=None, alibi: bool = False, softcap=None,
                  q_scale: float = 1.0, dtype=None, shared_pages: int = 0):
    """A paged-attention batch over a cache of ``widths`` as _paged_case
    describes it: (q, cache, layer, block table, seen, lens) and the
    wrapper's keywords (page size, window, ALiBi, softcap, int8 scales).
    Queries and a float cache are ``dtype`` (bf16 by default); an int8
    cache quantizes a bf16 one, as the engine does. ``shared_pages``: every
    row's table starts with row 0's first pages, as sequences that adopted
    one cached prefix share them."""
    import torch
    dtype = dtype or torch.bfloat16
    L, KV, G, D, ps, n_pages, layer = (widths[k] for k in (
        "L", "KV", "G", "D", "ps", "n_pages", "layer"))
    S = len(seen)
    cache = torch.randn(2 * L, n_pages * ps, KV * D, generator=gen, device="cuda",
                        dtype=torch.bfloat16 if int8 else dtype)
    kw = {"page_size": ps, "window": window, "use_alibi": alibi, "softcap": softcap}
    if int8:
        cache, kw["cache_scales"] = int8_kv(cache, D)
    q = (q_scale * torch.randn(S, N, KV * G, D, generator=gen, device="cuda")).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    bt = perm[:S * B].reshape(S, B).to(torch.int32)
    bt[:, :shared_pages] = bt[:1, :shared_pages]
    for i, n in enumerate(n_new):
        if n == 0:
            bt[i] = 0
        elif window:
            bt[i, :max(0, seen[i] - window + 1) // ps] = 0
    seen_t = torch.tensor(seen, dtype=torch.int32, device="cuda")
    lens_t = seen_t + torch.tensor(n_new, dtype=torch.int32, device="cuda")
    return (q, cache, layer, bt, seen_t, lens_t), kw


def k4_path(fn):
    """Runs ``fn`` (one K4 launch) and names the kernel that ran, by the
    wrapper's counters: the wgmma tiles, the bf16 decode kernel, the fp32
    chunk or decode kernel, or the CUDA-core kernel (one of them and no
    other must have counted it)."""
    from deepspeed_tpu_torch.ops.paged_attention import KERNEL_COUNTERS, KERNELS
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention as pa

    def counts():
        return [getattr(pa, c) for c in KERNEL_COUNTERS]
    before = counts()
    out = fn()
    ran = [k for k, a, b in zip(KERNELS, counts(), before) if a != b]
    return out, ran[0] if len(ran) == 1 and sum(counts()) == sum(before) + 1 else str(ran)


def k4_expected_path(shape: dict) -> str:
    """The kernel the plan's rule gives (csrc/paged_attention.cu plan()):
    for a bf16 query the wgmma tiles from the plan's wgmma_min_rows(D)
    folded rows at head widths 65..256, else the decode kernel at widths D
    % 16 == 0; for an fp32 query at D % 4 == 0 the fp32 chunk kernel from
    f32_chunk_min_rows() folded rows, else the fp32 decode kernel; the
    CUDA-core kernel for the rest."""
    from deepspeed_tpu_torch.ops.paged_attention import f32_chunk_min_rows, wgmma_min_rows
    rows, D = shape["N"] * shape["H"] // shape["KV"], shape["D"]
    if shape["dtype"] == "float32":
        if D % 4:
            return "cuda cores"
        return "fp32 chunk" if rows >= f32_chunk_min_rows() else "fp32 decode"
    if 64 < D <= 256 and rows >= wgmma_min_rows(D):
        return "wgmma"
    return "decode" if D % 16 == 0 else "cuda cores"


def _paged_case(gen, name: str, seen: list, n_new: list, N: int, B: int,
                graph: bool = False, int8: bool = False, widths=LLAMA_PAGED,
                window=None, alibi: bool = False, softcap=None,
                q_scale: float = 1.0, dtype=None, kernel=None,
                shared_pages: int = 0) -> dict:
    """One paged-attention batch over a cache of ``widths``, bf16 or
    (``int8``) int8 with its scales, with BLOOM's ALiBi bias where
    ``alibi`` and Gemma-2's ``softcap`` (queries drawn ``q_scale`` times
    wider, so that it bites: the record holds the share of visible scaled
    scores past cap / 2). The record's ``path`` names the kernel that ran
    (the wgmma tiles, the decode kernel or the CUDA-core kernel, by the
    wrapper's counters). A sequence with ``n_new`` 0 is a padding row
    (zero block table, no tokens). With a ``window``, the table entries of
    blocks wholly below the window of each sequence's first query hold 0,
    as the engine leaves them once it has freed them. fp32 queries
    (``dtype``, over an fp32 or an int8 cache) run the fp32 chunk or decode
    kernel and are held to fp32's tolerances as well (FP32_PAGED_TOL,
    FP32_PAGED_ROW_TOL). ``kernel`` names a kernel to run whatever the plan
    would choose (``run_kernel``), recorded as ``forced``. ``shared_pages``:
    the rows share their first pages (adopted prefixes), read once in the
    bound."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import (
        kernel_plan, paged_attention, paged_attention_reference, round_p_flip_bound,
        run_kernel)
    KV, G, D, ps, L = (widths[k] for k in ("KV", "G", "D", "ps", "L"))
    H, S = KV * G, len(seen)
    args, kw = _paged_inputs(gen, seen, n_new, N, B, int8, widths, window, alibi, softcap,
                             q_scale, dtype, shared_pages)
    q, cache, layer, bt, seen_t, lens_t = args
    kw.pop("page_size")

    def launch():
        if kernel is None:
            return paged_attention(*args, page_size=ps, **kw)
        return run_kernel(kernel, *args, page_size=ps, **kw)
    y, path = k4_path(launch)
    ref = paged_attention_reference(*args, page_size=ps, **kw)
    # the exact value: the plain version in fp32 on the K/V values the
    # kernel reads (an int8 cache's staged bf16 values)
    staged = staged_kv(cache, kw["cache_scales"], D) if int8 else cache
    exact = paged_attention_reference(q.float(), staged, layer, bt, seen_t, lens_t,
                                      page_size=ps, window=window, use_alibi=alibi,
                                      softcap=softcap)
    bite = (cap_bite_share(q, staged, layer, bt, seen, n_new, ps, window, softcap)
            if softcap else None)
    control = exact.to(q.dtype)  # one rounding of it; for a bf16 cache, = ref
    torch.cuda.synchronize()
    errs = {"max_abs_err": (y.float() - ref.float()).abs().max().item(),
            "row_rel_err": row_rel_err(y, ref),
            "rounding_row_rel_err": row_rel_err(control, exact)}
    if int8:
        errs.update({"staged_row_rel_err": row_rel_err(y, control),
                     "control_row_rel_err": row_rel_err(control, ref),
                     "control_max_abs_err": (y.float() - control.float()).abs().max().item()})
    if q.dtype == torch.float32 and int8:
        # the kernel rounds P to bf16 against each split's running max,
        # which steps once per key tile (the CUDA-core kernel's: per page):
        # the plain version that follows its split and steps, and what
        # summation order can move through that rounding
        _, pages, keys = kernel_plan(q, cache, bt, page_size=ps, window=window, kernel=kernel)
        rkw = dict(page_size=ps, window=window, use_alibi=alibi, softcap=softcap,
                   split_pages=pages, tile_keys=keys)
        rounded = paged_attention_reference(q, staged, layer, bt, seen_t, lens_t,
                                            round_p=True, **rkw)
        flips = round_p_flip_bound(q, staged, layer, bt, seen_t, lens_t, **rkw)
        gap = (y - rounded).abs()
        errs.update({"split_pages": pages, "tile_keys": keys,
                     "round_p_max_abs_err": gap.max().item(),
                     "round_p_excess": (gap - FP32_PAGED_TOL - flips).max().item(),
                     "flip_bound_max": flips.max().item(),
                     "unrounded_outside_share": ((exact - rounded).abs()
                                                 > FP32_PAGED_TOL + flips).float().mean().item()})
        del rounded, flips, gap
    elif q.dtype == torch.float32:
        errs["fp32_row_rel_err"] = errs["row_rel_err"]
    del ref, staged, exact, control
    # bytes: q read + out written + each sequence's visible K and V rows
    # (int8: D codes and a 4-byte scale per head); with a window, the keys
    # some query of the sequence sees
    W = window or (1 << 30)
    kv_tokens = sum(s + n - max(0, s - W + 1) for s, n in zip(seen, n_new) if n)
    kv_tokens -= (S - 1) * shared_pages * ps  # shared pages read once
    row_bytes = KV * (D + 4) if int8 else KV * D * cache.element_size()
    nbytes = (2 * q.numel() * q.element_size() + 2 * kv_tokens * row_bytes
              + bt.numel() * 4 + 2 * S * 4)
    # flops: QK and PV for each real query row and head over its visible
    # keys, at the tensor cores' bf16 rate, or fp32's for fp32 queries
    visible = sum(min(s + n + 1, W) for s, nn in zip(seen, n_new) for n in range(nn))
    flops = 4 * D * H * visible
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / (FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS) * 1e3
    timer = graph_time_ms if graph else time_ms
    rec = {"case": name, "shape": {"S": S, "N": N, "B": B, "H": H, "KV": KV,
                                   "D": D, "page_size": ps, "layers": L,
                                   "seen": seen, "n_new": n_new, "window": window,
                                   "alibi": alibi, "softcap": softcap, "q_scale": q_scale,
                                   "dtype": str(q.dtype)[6:],
                                   "cache": "int8" if int8 else str(cache.dtype)[6:],
                                   "shared_pages": shared_pages},
           "path": path, "forced": kernel, **errs,
           "timing": "cuda graph" if graph else "events", "ms": timer(launch),
           "plain_ms": timer(lambda: paged_attention_reference(*args, page_size=ps, **kw)),
           "library_ms": None,
           "bound_ms": max(bound_bytes, bound_flops),
           "bound_by": "bytes" if bound_bytes >= bound_flops else "operations"}
    if softcap:
        rec["cap_bite_share"] = bite
    del cache, kw
    torch.cuda.empty_cache()
    return rec


def cap_bite_share(q, cache, layer: int, bt, seen: list, n_new: list, ps: int, window,
                   cap: float) -> float:
    """The share of K4's visible scaled scores (q.k / sqrt(D), over each
    real query row's visible keys and every head) with |s| > cap / 2: where
    the cap changes a score by more than 8%."""
    import torch
    S, N, H, D = q.shape
    KV = cache.shape[-1] // D
    big = total = 0
    for s, (sn, nn) in enumerate(zip(seen, n_new)):
        if nn == 0:
            continue
        keys = torch.arange(sn + nn, device=q.device)
        slots = bt[s].long()[keys // ps] * ps + keys % ps
        k = cache[2 * layer][slots].float().view(-1, KV, 1, D)
        qs = q[s, :nn].float().view(nn, KV, H // KV, D)
        sc = torch.einsum("nkgd,pkgd->nkgp", qs, k.expand(-1, -1, H // KV, -1)) * D ** -0.5
        qpos = sn + torch.arange(nn, device=q.device)[:, None]
        vis = keys[None, :] <= qpos
        if window:
            vis &= keys[None, :] > qpos - window
        vis = vis[:, None, None, :].expand_as(sc)
        big += int((sc.abs() > cap / 2)[vis].sum())
        total += int(vis.sum())
    return big / total


def flash_cap_bite_share(q, k, causal: bool, window, cap: float, rows: int = 256) -> float:
    """The share of the flash kernels' visible scaled scores with |s| >
    cap / 2, over ``rows`` evenly spaced query positions, every head."""
    import torch
    B, S, H, D = q.shape
    KV = k.shape[2]
    pos = torch.linspace(0, S - 1, rows, device=q.device).long()
    qs = q[:, pos].float().view(B, rows, KV, H // KV, D)
    sc = torch.einsum("bqkgd,bpkd->bkgqp", qs, k.float()) * D ** -0.5
    keys = torch.arange(S, device=q.device)
    vis = torch.ones(rows, S, dtype=torch.bool, device=q.device)
    if causal:
        vis &= keys[None, :] <= pos[:, None]
    if window:
        vis &= pos[:, None] - keys[None, :] < window
    vis = vis.expand_as(sc)
    return float((sc.abs() > cap / 2)[vis].float().mean())


def _quant_case(gen, name: str, shape: tuple, zero_block: bool = False) -> dict:
    """K6 on a bf16 weight of ``shape`` at block 512 (the engine's group
    size): equal to the plain version bit for bit; the kernel graph-timed
    (the plain version, many launches, by events)."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer import (
        quantize_int8_blockwise, quantize_int8_blockwise_reference)
    x = (0.02 * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)
    if zero_block:
        x.view(-1)[512 * 3:512 * 5] = 0  # two all-zero blocks: scale 1
    v, s = quantize_int8_blockwise(x, 512)
    v_ref, s_ref = quantize_int8_blockwise_reference(x, 512)
    torch.cuda.synchronize()
    equal = torch.equal(v, v_ref) and torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    # bytes: the bf16 weight read once, the codes (padding included) and
    # the scales written once
    nbytes = x.numel() * 2 + v.numel() + s.numel() * 4
    rec = {"case": name, "shape": list(shape), "block": 512, "equal": equal,
           "max_abs_err": max((v.int() - v_ref.int()).abs().max().item(),
                              (s - s_ref).abs().max().item()),
           "timing": "cuda graph",
           "ms": graph_time_ms(lambda: quantize_int8_blockwise(x, 512)),
           "plain_ms": time_ms(lambda: quantize_int8_blockwise_reference(x, 512), iters=5),
           "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    if zero_block:
        rec["zero_block_scales"] = s[3:5].tolist()
    return rec


def _dequant_case(gen, shape: tuple) -> dict:
    """The dequantize helper on K6's output of a bf16 weight of ``shape``,
    into a reused bf16 buffer as the engine calls it: equal bit for bit."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer import (
        dequantize_int8_blockwise, dequantize_int8_blockwise_reference,
        quantize_int8_blockwise_reference)
    x = (0.02 * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)
    v, s = quantize_int8_blockwise_reference(x, 512)
    out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
    y = dequantize_int8_blockwise(v, s, shape, 512, dtype=torch.bfloat16, out=out)
    ref = dequantize_int8_blockwise_reference(v, s, shape, 512, torch.bfloat16)
    torch.cuda.synchronize()
    equal = torch.equal(y.view(torch.int16), ref.view(torch.int16))
    nbytes = v.numel() + s.numel() * 4 + out.numel() * 2
    return {"case": "llama3_8b gate/up kernel", "shape": list(shape), "block": 512,
            "equal": equal, "max_abs_err": (y.float() - ref.float()).abs().max().item(),
            "timing": "events",
            "ms": time_ms(lambda: dequantize_int8_blockwise(
                v, s, shape, 512, dtype=torch.bfloat16, out=out)),
            "plain_ms": time_ms(lambda: dequantize_int8_blockwise_reference(
                v, s, shape, 512, torch.bfloat16)),
            "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def row_rel_err(x, ref, floor: float = 2.0 ** -10) -> float:
    """The largest ||x - ref|| / ||ref|| over the rows of the last dim
    (a head's D values at one position). A row's norm is floored at
    ``floor`` of the RMS row norm: a row whose exact value cancels to ~0
    (dq of a query that sees only its own key) carries fp32 noise, up to
    ~1.1e-5 of the RMS row on the H100 (fp16; bf16 ~7e-6), and the flash
    cases set the floor so that their tolerance allows it 2^-16 (2^-10 at
    bf16's 2^-6)."""
    x, ref = x.float().flatten(0, -2), ref.float().flatten(0, -2)
    den = ref.norm(dim=-1)
    rms = den.square().mean().sqrt()
    return ((x - ref).norm(dim=-1) / den.clamp_min(floor * rms)).max().item()


def visible_pairs(S: int, causal: bool, window=None) -> int:
    """The (query, key) pairs of one head that a mask leaves visible: all
    S^2, the causal triangle, or under a window each query's last
    ``window`` keys (causal) or the keys less than ``window`` behind it."""
    if window is None:
        return S * (S + 1) // 2 if causal else S * S
    w = min(window, S)
    behind = w * (w + 1) // 2 + (S - w) * w  # keys at or before the query
    return behind if causal else behind + S * (S - 1) // 2


def _flash_case(gen, name: str, B: int, S: int, causal: bool, dtype=None,
                window=None, softcap=None, layout: str = "per_head",
                widths=(32, 8, 128), q_scale: float = 1.0) -> dict:
    """K1 and both K2 passes (``layout="per_head"``) or K3's three passes
    (``"folded"``) at the training path's Llama-3-8B / Mistral-7B widths
    (H 32, KV 8, D 128) in bf16 (or ``dtype``, fp16 for fp16 training),
    with the ``window`` and ``softcap`` options, each against its plain
    version on identical inputs (the backward passes take the plain
    forward's o and lse). Each also stands beside the exact value, the
    plain version on the same inputs in fp64 (no rounding of P, dS or the
    output, and no fp32 rounding either: a row that cancels to fp32 noise
    reads that noise in the plain version as in the kernel), with the
    plain version's error and one rounding of the exact value to
    ``dtype`` as controls. The library time is SDPA's (an
    explicit boolean mask serves the window), or with the softcap
    flex_attention's with the cap as its ``score_mod``; at head width 256
    (Gemma-2's ``widths``, H 16, KV 8) SDPA's causal time without the cap
    stands beside it too. With the softcap, q is drawn ``q_scale`` times
    wider and the record holds the share of scaled scores past cap / 2.
    The library calls run in ``dtype``."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops import attention_folded as ff
    H, KV, D = widths
    dtype = dtype or torch.bfloat16
    opts = dict(window=window, softcap=softcap)
    fwd_k, dq_k, dkdv_k = ((fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                            fa.flash_attention_bwd_dkdv) if layout == "per_head" else
                           (ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
                            ff.folded_attention_bwd_dkdv))

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D), rnd(B, S, H, D)
    esize = q.element_size()
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(dtype)
    bite = flash_cap_bite_share(q, k, causal, window, softcap) if softcap else None
    o, lse = fwd_k(q, k, v, causal, **opts)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal, **opts)
    delta = fa.attention_delta(o_ref, do)
    bwd_args = (q, k, v, do, lse_ref, delta, causal)
    dq = dq_k(*bwd_args, **opts)
    dk, dv = dkdv_k(*bwd_args, **opts)
    dq_ref = fa.flash_attention_bwd_dq_reference(*bwd_args, D ** -0.5, **opts)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkdv_reference(*bwd_args, D ** -0.5, **opts)
    exact_args = tuple(t.double() for t in (q, k, v, do, lse_ref, delta)) + (causal, )
    exact = {"fwd": [fa.flash_attention_fwd_reference(*exact_args[:3], causal, **opts)[0]],
             "dq": [fa.flash_attention_bwd_dq_reference(*exact_args, D ** -0.5, **opts)],
             "dkdv": list(fa.flash_attention_bwd_dkdv_reference(*exact_args, D ** -0.5,
                                                                **opts))}
    torch.cuda.synchronize()
    got = {"fwd": [(o, o_ref)], "dq": [(dq, dq_ref)], "dkdv": [(dk, dk_ref), (dv, dv_ref)]}
    # the floor gives a cancelling row 2^-16 of the RMS row at any
    # tolerance; against the exact value, FLASH_EXACT_FLOOR
    name_dtype = str(dtype).replace("torch.", "")
    row_tol = FLASH_D256_ROW_TOL if D > 128 and esize == 2 else FLASH_ROW_TOL[name_dtype]
    floor = 2.0 ** -16 / FLASH_ROW_TOL[name_dtype]
    vs = dict(floor=FLASH_EXACT_FLOOR[name_dtype])
    errs = {}
    for key, pairs in got.items():
        errs[key] = {
            "max_abs_err": max((x.float() - r.float()).abs().max().item() for x, r in pairs),
            "row_rel_err": max(row_rel_err(x, r, floor) for x, r in pairs),
            "vs_exact": {
                "kernel": max(row_rel_err(x, e, **vs) for (x, _), e in zip(pairs, exact[key])),
                "plain": max(row_rel_err(r, e, **vs) for (_, r), e in zip(pairs, exact[key])),
                "one_rounding": max(row_rel_err(e.to(dtype), e, **vs)
                                     for e in exact[key])}}
    lse_err = (lse - lse_ref).abs().max().item()
    del o, o_ref, lse, dq, dk, dv, dq_ref, dk_ref, dv_ref, exact, exact_args, got

    free_memory()

    def sdpa_times(**kw):
        """SDPA's forward, and forward + backward less the forward."""
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, **kw)

        f = time_ms(lambda: sdpa(qt, kt, vt))
        return f, time_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, dot)) - f

    # at head width 256, SDPA's causal attention without the cap as a
    # second yardstick
    sdpa_nocap = (sdpa_times(is_causal=causal, enable_gqa=True)
                  if D > 128 and softcap is not None else None)
    free_memory()
    # SDPA, timed as the yardstick only: forward, and forward + backward
    # less the forward for the backward. A window goes in as a boolean
    # mask, over K/V repeated to the query heads (SDPA's masked kernels do
    # not take GQA); no SDPA call computes the softcap: flex_attention with
    # the softcap as its score_mod does
    if softcap is not None:
        def cap(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)

        def mask_mod(b, h, q_idx, kv_idx):
            keep = kv_idx <= q_idx if causal else q_idx >= 0
            return keep & (q_idx - kv_idx < window) if window is not None else keep

        flex = _flex_times(*(x.transpose(1, 2).contiguous() for x in (q, k, v, do)),
                           mask_mod, score_mod=cap)
        lib_fwd, lib_bwd = flex["fwd"], flex["bwd"]
        free_memory()
    else:
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        kw = dict(is_causal=causal, enable_gqa=True)
        if window is not None:
            pos = torch.arange(S, device="cuda")
            mask = (pos[:, None] - pos[None, :]) < window
            if causal:
                mask &= pos[None, :] <= pos[:, None]
            kt, vt = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))
            kw = dict(attn_mask=mask)
        leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, **kw)

        lib_fwd = time_ms(lambda: sdpa(qt, kt, vt))
        lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, dot)) - lib_fwd
        del qt, kt, vt, dot, leaves, kw
        free_memory()

    # operations: 4*D (fwd), 6*D (dq: QK^T, dO V^T, dS K), 8*D (dk/dv: QK^T,
    # dO V^T, P^T dO, dS^T Q) per visible (query, key) pair and query head;
    # bytes: each input read once, each output written once
    pairs = visible_pairs(S, causal, window)
    qb, kvb, rb = B * S * H * D * esize, B * S * KV * D * esize, B * S * H * 4
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS  # fp32: CUDA cores
    work = {"fwd": (4, 2 * qb + 2 * kvb + rb),
            "dq": (6, 3 * qb + 2 * kvb + 2 * rb),
            "dkdv": (8, 2 * qb + 4 * kvb + 2 * rb)}
    timed = {
        "fwd": (lambda: fwd_k(q, k, v, causal, **opts),
                lambda: fa.flash_attention_fwd_reference(q, k, v, causal, **opts), lib_fwd),
        "dq": (lambda: dq_k(*bwd_args, **opts),
               lambda: fa.flash_attention_bwd_dq_reference(*bwd_args, D ** -0.5, **opts),
               lib_bwd),
        "dkdv": (lambda: dkdv_k(*bwd_args, **opts),
                 lambda: fa.flash_attention_bwd_dkdv_reference(*bwd_args, D ** -0.5,
                                                              **opts),
                 lib_bwd),
    }
    rec = {"case": name, "layout": layout,
           "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "causal": causal,
                     "window": window, "softcap": softcap, "q_scale": q_scale},
           "visible_pairs_per_head": pairs, "dtype": name_dtype, "lse_max_abs_err": lse_err,
           "row_tolerance": row_tol,
           "library": "flex_attention (compiled, softcap score_mod)" if softcap else "SDPA"}
    if softcap is not None:
        rec["cap_bite_share"] = bite
    if sdpa_nocap is not None:
        rec["sdpa_causal_without_cap_ms"] = {"fwd": sdpa_nocap[0], "bwd": sdpa_nocap[1]}
    for key, (kernel, plain, library) in timed.items():
        flops = work[key][0] * D * pairs * H * B
        bound_flops = flops / peak * 1e3
        bound_bytes = work[key][1] / HBM_BYTES_PER_S * 1e3
        rec[key] = {**errs[key], "tolerance": rec["row_tolerance"],
                    "ms": time_ms(kernel), "plain_ms": time_ms(plain, iters=5),
                    # SDPA's backward computes dq, dk and dv in one call: the
                    # same time stands beside both backward passes
                    "library_ms": library, "gflop": flops / 1e9,
                    "bound_ms": max(bound_flops, bound_bytes),
                    "bound_by": "operations" if bound_flops >= bound_bytes else "bytes"}
    del q, k, v, do, delta, bwd_args, timed
    free_memory()
    return rec


# tolerances against the plain versions, bf16 in and out: both compute in
# fp32 and round once to bf16, so they differ by summation order and that
# rounding — one or two bf16 ulps of the output's magnitude
RMS_TOL = 6.25e-2      # |y| up to ~5 for N(0,1) rows: two ulps at [4, 8)
# K5b: bf16 as K5 (|y| up to ~5); fp32 summation order only, the means up
# to 3 costing a few ulps of 3 in every centred value
LN_TOL = {"torch.bfloat16": 6.25e-2, "torch.float32": 1e-4}
PAGED_TOL = 1.6e-2     # |out| < 1 (softmax-weighted mean of N(0,1) values)
# K4 is also held row by row (a head's D values at one query), as flash is:
# the largest ||kernel - plain|| / ||plain|| of any row may exceed one bf16
# rounding of the exact fp32 output on the same inputs (read in the same
# case) by at most 2^-8. Both compute in fp32 and round once, so they differ
# by an ulp where the two fp32 values straddle a rounding boundary. Over
# thousands of keys (StarCoder2's window) an output is ~0.03 and max abs
# says little; a dropped 64-key page moves a row by ~10% of its norm.
PAGED_ROW_SLACK = 2.0 ** -8
# K4 with fp32 queries (the fp32 chunk and decode kernels; the CUDA-core
# kernel where named). Over an fp32 cache both keep fp32 throughout and
# differ by summation order and the last ulps of the cap's tanh (scores up
# to 50): the largest row error 2^-14. Over an int8 cache the kernel rounds
# P to bf16 before P V against each split's running max, which steps once
# per key tile (the CUDA-core kernel's: per page): element by element
# within 2e-5 of the plain version that follows its split and steps
# (round_p, split_pages, tile_keys), plus round_p_flip_bound, what
# summation order can move through that rounding (one bf16 ulp of each P
# that lies within 512 fp32 ulps of a rounding tie)
FP32_PAGED_TOL = 2e-5
FP32_PAGED_ROW_TOL = 2.0 ** -14
# flash, held row by row (a head's D values at one position): the largest
# ||kernel - plain|| / ||plain|| of any row. Both round P (or dS) to bf16
# before its product and the output once, at other points (the kernel
# rounds P before dividing by the row sum): a few roundings of 2^-8 (bf16's
# unit roundoff) each, so 2^-6 of the row. Against the exact value the
# kernel may be at most FLASH_EXACT_RATIO times as far off as the plain
# bf16 version.
# fp16 rounds P, dS and the output at its unit roundoff 2^-11: 2^-8.
# fp32 (head width 256): both compute and keep fp32 throughout and differ by
# summation order only: 2^-14.
FLASH_ROW_TOL = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -8, "float32": 2.0 ** -14}
FLASH_EXACT_RATIO = 2.0
# against the exact value a row's norm is floored at this share of the RMS
# row: a row that cancels to ~0 (dq at position 0, which sees one key)
# carries fp32 noise, up to ~7e-6 of the RMS row in bf16 at S 2048 and
# ~1.1e-5 at S 8192 (the RMS row shrinks as P spreads over more keys),
# ~1.1e-5 in fp16. The exact value is computed in fp64, so that noise
# shows in the plain version's error as in the kernel's; before, the exact
# value was the plain version's own fp32 einsums, which read 0 there.
# fp32 takes the floor of its comparison with the plain version (2^-16 /
# 2^-14).
FLASH_EXACT_FLOOR = {"bfloat16": 2.0 ** -10, "float16": 2.0 ** -6, "float32": 2.0 ** -2}
LSE_TOL = 1e-3         # fp32 lse of ~10: summation order only
# the Mistral phase's attention: S 8192 under a 4096-token window; the
# softcap the phase-2 cases take (Gemma-2's 50.0)
MISTRAL_S, MISTRAL_WINDOW = 8192, 4096
FLASH_SOFTCAP = 50.0
# a softcap case must change scores: at least this share of its visible
# scaled scores past cap / 2 (where the cap moves a score by more than 8%)
CAP_BITES = 0.1
# at head width 256 the kernel against the plain version row by row, in
# every dtype: a dq row sums 256-wide products of dS rounded to the input
# dtype over thousands of keys, and where it cancels an fp16 pair of them
# read 4.8e-3 in the cuda tests (fp16's 2^-8 holds at the narrower widths);
# against the exact value FLASH_EXACT_RATIO holds as everywhere
FLASH_D256_ROW_TOL = 2.0 ** -6
# K4 over an int8 cache stages each K/V element as the TPU kernel does,
# bf16(code) * bf16(scale) rounded to bf16, where the plain version
# dequantizes in fp32. Against the plain version on those staged values
# (the control): as a bf16 cache, row by row. Against the plain version
# itself, row by row, one bf16 rounding of K and V is allowed: the
# control's own row error on the same inputs, plus PAGED_ROW_SLACK.
PAGED_TOLERANCE = (f"max abs <= {PAGED_TOL}; the largest row error ||kernel - plain|| / "
                   "||plain|| <= one bf16 rounding's of the exact fp32 output + 2^-8")
F32_TOLERANCE = (f"fp32 cache: the largest row error <= {FP32_PAGED_ROW_TOL}; int8 cache: "
                 f"within {FP32_PAGED_TOL} + round_p_flip_bound "
                 "of the plain version that follows the kernel's split and running-max steps "
                 "with P rounded (round_p, split_pages, tile_keys); and each as paged_attention")
F32_SOURCES = ["deepspeed_tpu_torch/csrc/paged_f32_f32.cu",
               "deepspeed_tpu_torch/csrc/paged_f32_f32_d256.cu",
               "deepspeed_tpu_torch/csrc/paged_f32_int8.cu",
               "deepspeed_tpu_torch/csrc/paged_f32_int8_d256.cu",
               "deepspeed_tpu_torch/csrc/paged_f32.cuh",
               "deepspeed_tpu_torch/csrc/paged_decode.cuh"]
FLASH_KERNELS = (("fwd", "flash_attention_fwd", "deepspeed_tpu/ops/attention.py:88"),
                 ("dq", "flash_attention_bwd_dq", "deepspeed_tpu/ops/attention.py:273"),
                 ("dkdv", "flash_attention_bwd_dkdv", "deepspeed_tpu/ops/attention.py:350"))


def flash_source(layout: str, key: str, d256: bool = False, dtype: str = "bfloat16") -> str:
    """The source that builds a flash pass's instance: K3's entry points
    (which launch K1/K2's kernels), the wgmma kernels' own sources for
    every pass in bf16 and fp16, else K1/K2's fp32 ones (``_d256`` at
    256)."""
    width = "_d256" if d256 else ""
    if layout == "folded":
        return "deepspeed_tpu_torch/csrc/flash_attention_folded.cu"
    if dtype != "float32":
        return f"deepspeed_tpu_torch/csrc/flash_attention_{key}{width}.cu"
    return f"deepspeed_tpu_torch/csrc/flash_attention{width}.cu"


FOLDED_KERNELS = (
    ("fwd", "folded_attention_fwd", "deepspeed_tpu/ops/attention_folded.py:69"),
    ("dq", "folded_attention_bwd_dq", "deepspeed_tpu/ops/attention_folded.py:146"),
    ("dkdv", "folded_attention_bwd_dkdv", "deepspeed_tpu/ops/attention_folded.py:215"))



def ulp_distance(x, ref) -> int:
    """The largest distance in units in the last place between two float
    tensors of one dtype (fp32 or a 16-bit type), both signs ordered on one
    integer line."""
    import torch
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[ref.dtype]
    bits = torch.iinfo(ints).bits

    def key(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i >= 0, i, -(1 << (bits - 1)) - i)

    return int((key(x) - key(ref)).abs().max().item())


# K7 at the training phase's width: one Llama-3-8B layer's parameters (its
# 9 tensors: two norms, q/k/v/o, gate/up/down) and a ragged tail
LAYER_SEGMENTS = (4096, 4096 * 4096, 4096 * 1024, 4096 * 1024, 4096 * 4096, 4096,
                  4096 * 14336, 4096 * 14336, 14336 * 4096)
LAYER_PARAMS = sum(LAYER_SEGMENTS)  # 218,112,000
K7_TAIL = 12_391
K7_ULPS = 2
# peak fp32 rate outside the tensor cores (NVIDIA data sheet, H100 SXM)
FP32_FLOPS = 67e12
# per element: bytes (each input read once, each output written once, fp32)
# and fp32 operations of each body; lamb_step is the whole step through
# fused_lamb_step (p, g, m, v in; p, m, v out), trust ratio included
K7_WORK = {"adamw": (28, 15), "adam_l2": (28, 15), "lion": (20, 8),
           "lamb_pass": (24, 12), "lamb_step": (28, 19)}
K7_KERNELS = (("fused_adam_step", "adam_step_", ("adamw", "adam_l2"),
               "deepspeed_tpu/ops/fused_optimizer.py:67"),
              ("fused_lion_step", "lion_step_", ("lion", ),
               "deepspeed_tpu/ops/fused_optimizer.py:115"),
              ("fused_lamb_step", "lamb_update_", ("lamb_pass", "lamb_step"),
               "deepspeed_tpu/ops/fused_optimizer.py:152"))


def _k7_case(gen, body: str, n: int) -> dict:
    """One K7 body over flat fp32 buffers of ``n`` elements at update count
    3 (p ~ 0.02 N(0,1), g ~ 1e-3 N(0,1), m ~ 1e-4 N(0,1), v ~ 1e-8 U(0,1);
    the first 5 elements with g = m = v = 0), against its plain version on
    the same inputs: the largest ulp distance of each output. Kernel time
    from a CUDA graph of 20 in-place calls, the plain version's with events;
    beside adam, torch.optim's fused Adam/AdamW step on the same tensors."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as fo

    def rnd(scale, uniform=False):
        x = (torch.rand if uniform else torch.randn)(n, generator=gen, device="cuda")
        return scale * x

    p, g, m, v = rnd(0.02), rnd(1e-3), rnd(1e-4), rnd(1e-8, uniform=True)
    for t in (g, m, v):
        t[:5] = 0
    wd = 0.1 if body in ("adamw", "lion") else 0.01
    # K7 reads its learning rate and update count from device memory
    lr, step = (fo.device_scalar(x, "cuda") for x in (1e-4, 3))
    bounds = (0, ) + tuple(itertools.accumulate(LAYER_SEGMENTS))
    segments = bounds if n == LAYER_PARAMS else None
    st = [t.clone() for t in (p, m, v)]  # the kernel's in-place state
    if body in ("adamw", "adam_l2"):
        l2 = body == "adam_l2"
        ref = fo.adam_update_reference(p, g, m, v, lr, step, weight_decay=wd, l2=l2)

        def kernel():
            return fo.adam_step_(st[0], g, st[1], st[2], lr, step, weight_decay=wd, l2=l2)

        def plain():
            return fo.adam_update_reference(p, g, m, v, lr, step, weight_decay=wd, l2=l2)
    elif body == "lion":
        ref = fo.lion_update_reference(p, g, m, lr, weight_decay=wd)

        def kernel():
            return fo.lion_step_(st[0], g, st[1], lr, weight_decay=wd)

        def plain():
            return fo.lion_update_reference(p, g, m, lr, weight_decay=wd)
    elif body == "lamb_pass":
        ref = fo.lamb_update_reference(g, m, v, step)
        u = torch.empty_like(g)

        def kernel():
            return fo.lamb_update_(g, st[1], st[2], step, out=u), st[1], st[2]

        def plain():
            return fo.lamb_update_reference(g, m, v, step)
    else:  # lamb_step: the pass and the per-segment trust ratio
        ref = fo.fused_lamb_step_reference(p, g, m, v, lr, step, weight_decay=wd,
                                           segments=segments)

        def kernel():
            return fo.fused_lamb_step(p, g, m, v, lr, step, weight_decay=wd,
                                      segments=segments)

        def plain():
            return fo.fused_lamb_step_reference(p, g, m, v, lr, step, weight_decay=wd,
                                                segments=segments)
    got = kernel()
    torch.cuda.synchronize()
    names = "umv" if body == "lamb_pass" else "pm" if body == "lion" else "pmv"
    ulps = {k: ulp_distance(x, r) for k, x, r in zip(names, got, ref)}
    errs = max((x - r).abs().max().item() for x, r in zip(got, ref))
    del got, ref
    nbytes, flops = (w * n for w in K7_WORK[body])
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / FP32_FLOPS * 1e3
    large = n >= LAYER_PARAMS
    rec = {"case": body, "n": n, "segments": len(bounds) - 1 if segments else 1,
           "ulps": ulps, "max_ulps": max(ulps.values()), "max_abs_err": errs,
           "timing": "cuda graph (kernel), events (plain, library)",
           "ms": (time_ms if body == "lamb_step" else graph_time_ms)(kernel),
           "plain_ms": time_ms(plain, iters=5 if large else 20),
           "library_ms": None, "bound_ms": max(bound_bytes, bound_flops),
           "bound_by": "bytes" if bound_bytes >= bound_flops else "operations"}
    if body in ("adamw", "adam_l2"):
        # the same function in one PyTorch call: Adam (L2) or AdamW, fused
        lib_p = p.clone().requires_grad_()
        lib_p.grad = g
        cls = torch.optim.AdamW if body == "adamw" else torch.optim.Adam
        opt = cls([lib_p], lr=lr, weight_decay=wd, fused=True)
        rec["library_ms"] = time_ms(opt.step, iters=20 if large else 50)
        rec["library"] = f"torch.optim.{cls.__name__}(fused=True).step"
        del opt, lib_p
    del p, g, m, v, st
    free_memory()
    return rec


# K8 at BERT-large's attention width (hidden 1024, 16 heads: head_dim 64),
# S 4096, B 4, bf16, under the reference's default layouts at block 16
# (sparsity_config.py), plus the fixed layout at block 64
SPLASH_SHAPE = dict(B=4, H=16, S=4096, D=64)
SPLASH_LAYOUTS = (("fixed", "FixedSparsityConfig", 16), ("bigbird", "BigBirdSparsityConfig", 16),
                  ("bslongformer", "BSLongformerSparsityConfig", 16),
                  ("fixed_block64", "FixedSparsityConfig", 64))
SPLASH_KERNELS = (
    ("fwd", "splash_attention_fwd", "deepspeed_tpu/ops/sparse_attention/splash.py:63"),
    ("dq", "splash_attention_bwd_dq", "deepspeed_tpu/ops/sparse_attention/splash.py:165"),
    ("dkdv", "splash_attention_bwd_dkdv",
     "deepspeed_tpu/ops/sparse_attention/splash.py:201"))
# the second passes of the three passes over split groups: (key, wrapper,
# the pass whose plan they follow, what they replace)
SPLASH_SECOND = (
    ("fwd_merge", "splash_fwd_merge", "fwd",
     "deepspeed_tpu/ops/sparse_attention/splash.py:63"),
    ("dq_sum", "splash_dq_sum", "fwd", "deepspeed_tpu/ops/sparse_attention/splash.py:165"),
    ("dkdv_sum", "splash_dkdv_sum", "dkdv", "deepspeed_tpu/ops/sparse_attention/splash.py:201"))
SPLASH_SOURCES = {key: "deepspeed_tpu_torch/csrc/splash_grouped.cuh"
                  for key in ("fwd", "dq", "dkdv", "fwd_merge", "dq_sum", "dkdv_sum")}
# which kernel runs each K8 pass: the grouped sweeps over a host plan (dq
# over the forward's)
SPLASH_PATHS = {"fwd": "grouped", "dq": "grouped", "dkdv": "grouped"}


def splash_layout(config: str, block: int):
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
    cfg = getattr(sc, config)(num_heads=SPLASH_SHAPE["H"], block=block)
    return cfg, cfg.make_layout(SPLASH_SHAPE["S"])


def _flex_times(q, k, v, do, mask_mod, score_mod=None):
    """flex_attention (compiled) over q ``[B, H, S, D]`` and k/v ``[B, KV,
    S, D]`` with a BlockMask from ``mask_mod`` (and ``score_mod``): forward
    ms, and forward + backward less the forward. A yardstick only, but it
    stands on the kernels line: a failure raises."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    B, H, S, _ = q.shape
    bm = create_block_mask(mask_mod, B=None, H=H, Q_LEN=S, KV_LEN=S, device="cuda")
    # a fresh compile for each case: past dynamo's recompile limit (8 per
    # function) flex_attention would run unfused
    torch._dynamo.reset()
    flex = torch.compile(flex_attention)
    kw = dict(block_mask=bm, score_mod=score_mod, enable_gqa=k.shape[1] != H)
    fwd = time_ms(lambda: flex(q, k, v, **kw), iters=5)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    both = time_ms(lambda: torch.autograd.grad(flex(*leaves, **kw), leaves, do), iters=5)
    return {"fwd": fwd, "bwd": both - fwd}


def layout_mask_mod(layout, block: int):
    """flex_attention's mask_mod of a block-sparse layout: row b*H + h
    reads layout head h % layout_heads, as K8 does."""
    import numpy as np
    import torch
    lay = torch.from_numpy(np.asarray(layout).astype(bool)).cuda()
    Lh = lay.shape[0]

    def mask_mod(b, h, q_idx, kv_idx):
        return lay[h % Lh, q_idx // block, kv_idx // block]

    return mask_mod


def splash_plan_bytes(plan) -> int:
    """The bytes of a K8 plan a sweep reads: its items, entries and merge
    rows (int32)."""
    return 4 * (plan.items.numel() + plan.entries.numel() + plan.n_merges * plan.items.shape[1])


def splash_plan_record(plan) -> dict:
    """A K8 plan's shape: its work items, groups, split groups and their
    segments, the widest segment, the union/sum share of its groups, and
    the second-pass launches a call makes."""
    return {**plan.stats, "heads": plan.heads,
            "second_pass_launches": int(plan.n_merges > 0)}


def _splash_second_passes(q, k, v, bwd_args, tables) -> dict:
    """K8's merge (forward) and sums (dq, dk/dv) alone on the partials of
    this layout's split groups, each against its plain version on the same
    partials (the split rows, under the flash row rule), with its time and
    its bound: the partials read once and the split rows written once
    (bytes). None where the plan splits nothing."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import splash as sp
    B, H, S, D = q.shape
    floor = 2.0 ** -16 / FLASH_ROW_TOL["bfloat16"]
    out = {"fwd_merge": None, "dq_sum": None, "dkdv_sum": None}

    def split_rows(plan):  # the split groups' rows of [B * H * S]
        return torch.cat([rows[rows >= 0] for _, rows, _ in
                          sp.split_groups(plan, q.shape, q.device)])

    plan = tables.plan
    if plan.n_merges:
        o, lse, acc, ml = sp.splash_fwd_sweep(q, k, v, tables)
        (ok, lk), (op, lp) = (o.clone(), lse.clone()), (o.clone(), lse.clone())
        sp.splash_fwd_merge(ok, lk, plan, acc, ml)
        sp.splash_fwd_merge_reference(op, lp, plan, acc, ml)
        torch.cuda.synchronize()
        idx = split_rows(plan)
        kx, px = ok.view(-1, D)[idx], op.view(-1, D)[idx]
        moved = acc.numel() * 4 + ml.numel() * 4 + len(idx) * (D * 2 + 4)
        out["fwd_merge"] = {
            "max_abs_err": (kx.float() - px.float()).abs().max().item(),
            "row_rel_err": row_rel_err(kx, px, floor),
            "lse_max_abs_err": (lk.view(-1)[idx] - lp.view(-1)[idx]).abs().max().item(),
            "split_rows": len(idx), "merges": plan.n_merges, "segments": plan.n_parts,
            "ms": graph_time_ms(lambda: sp.splash_fwd_merge(ok, lk, plan, acc, ml)),
            "events_ms": time_ms(lambda: sp.splash_fwd_merge(ok, lk, plan, acc, ml)),
            "plain_ms": time_ms(lambda: sp.splash_fwd_merge_reference(op, lp, plan, acc, ml),
                                iters=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}
        del o, lse, acc, ml, ok, lk, op, lp
        dq, pq = sp.splash_dq_sweep(*bwd_args, tables)
        kern, plain = dq.clone(), dq.clone()
        sp.splash_dq_sum(kern, plan, pq)
        sp.splash_dq_sum_reference(plain, plan, pq)
        torch.cuda.synchronize()
        kx, px = kern.view(-1, D)[idx], plain.view(-1, D)[idx]
        moved = pq.numel() * 4 + len(idx) * D * 2
        out["dq_sum"] = {
            "max_abs_err": (kx.float() - px.float()).abs().max().item(),
            "row_rel_err": row_rel_err(kx, px, floor), "equal": torch.equal(kx, px),
            "split_rows": len(idx), "merges": plan.n_merges, "segments": plan.n_parts,
            "ms": graph_time_ms(lambda: sp.splash_dq_sum(kern, plan, pq)),
            "events_ms": time_ms(lambda: sp.splash_dq_sum(kern, plan, pq)),
            "plain_ms": time_ms(lambda: sp.splash_dq_sum_reference(plain, plan, pq), iters=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}
        del dq, pq, kern, plain
    plan = tables.plan_t
    if plan.n_merges:
        dk, dv, pk, pv = sp.splash_dkdv_sweep(*bwd_args, tables)
        kern = (dk.clone(), dv.clone())
        plain = (dk.clone(), dv.clone())
        sp.splash_dkdv_sum(*kern, plan, pk, pv)
        sp.splash_dkdv_sum_reference(*plain, plan, pk, pv)
        torch.cuda.synchronize()
        idx = split_rows(plan)
        pairs = [(x.view(-1, D)[idx], r.view(-1, D)[idx]) for x, r in zip(kern, plain)]
        moved = 2 * pk.numel() * 4 + 2 * len(idx) * D * 2
        out["dkdv_sum"] = {
            "max_abs_err": max((x.float() - r.float()).abs().max().item() for x, r in pairs),
            "row_rel_err": max(row_rel_err(x, r, floor) for x, r in pairs),
            "equal": all(torch.equal(x, r) for x, r in pairs),
            "split_rows": len(idx), "merges": plan.n_merges, "segments": plan.n_parts,
            "ms": graph_time_ms(lambda: sp.splash_dkdv_sum(*kern, plan, pk, pv)),
            "events_ms": time_ms(lambda: sp.splash_dkdv_sum(*kern, plan, pk, pv)),
            "plain_ms": time_ms(lambda: sp.splash_dkdv_sum_reference(*plain, plan, pk, pv),
                                iters=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}
        del dk, dv, pk, pv, kern, plain
    free_memory()
    return out


def _splash_case(gen, name: str, config: str, block: int) -> dict:
    """K8's forward, dq and dk/dv at ``SPLASH_SHAPE`` in bf16 under one
    layout, each against its plain version on identical inputs (the
    backward passes take the plain forward's o and lse), and beside the
    exact value (the plain versions in fp64) with the plain version's
    error and one rounding of it as controls, under phase 2's flash rule.
    Library times: flex_attention with a BlockMask from the layout, and
    SDPA with the dense boolean mask of ``layout_to_mask``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import attention_delta
    from deepspeed_tpu_torch.ops.sparse_attention import splash as sp
    from deepspeed_tpu_torch.ops.sparse_attention import splash_flops
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
        layout_to_mask
    B, H, S, D = (SPLASH_SHAPE[k] for k in ("B", "H", "S", "D"))
    _, layout = splash_layout(config, block)
    tables = sp.SplashTables.build(layout, block, "cuda")

    def rnd():
        return torch.randn(B, H, S, D, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    o, lse = sp.splash_attention_fwd(q, k, v, tables)
    o_ref, lse_ref = sp.splash_attention_fwd_reference(q, k, v, layout, block)
    delta = attention_delta(o_ref, do)
    bwd_args = (q, k, v, do, lse_ref, delta)
    dq = sp.splash_attention_bwd_dq(*bwd_args, tables)
    dk, dv = sp.splash_attention_bwd_dkdv(*bwd_args, tables)
    dq_ref = sp.splash_attention_bwd_dq_reference(*bwd_args, layout, block)
    dk_ref, dv_ref = sp.splash_attention_bwd_dkdv_reference(*bwd_args, layout, block)
    ex = tuple(t.double() for t in bwd_args)
    exact = {"fwd": [sp.splash_attention_fwd_reference(*ex[:3], layout, block)[0]],
             "dq": [sp.splash_attention_bwd_dq_reference(*ex, layout, block)],
             "dkdv": list(sp.splash_attention_bwd_dkdv_reference(*ex, layout, block))}
    torch.cuda.synchronize()
    got = {"fwd": [(o, o_ref)], "dq": [(dq, dq_ref)], "dkdv": [(dk, dk_ref), (dv, dv_ref)]}
    floor = 2.0 ** -16 / FLASH_ROW_TOL["bfloat16"]
    vs = dict(floor=FLASH_EXACT_FLOOR["bfloat16"])
    errs = {}
    for key, pairs in got.items():
        errs[key] = {
            "max_abs_err": max((x.float() - r.float()).abs().max().item() for x, r in pairs),
            "row_rel_err": max(row_rel_err(x, r, floor) for x, r in pairs),
            "vs_exact": {
                "kernel": max(row_rel_err(x, e, **vs) for (x, _), e in zip(pairs, exact[key])),
                "plain": max(row_rel_err(r, e, **vs) for (_, r), e in zip(pairs, exact[key])),
                "one_rounding": max(row_rel_err(e.to(torch.bfloat16), e, **vs)
                                     for e in exact[key])}}
    seen = lse_ref < sp.LSE_EMPTY  # lse compared only on rows that see a key
    lse_err = (lse[seen] - lse_ref[seen]).abs().max().item()
    lse_empty_ok = bool((lse[~seen] == sp.LSE_EMPTY).all())
    # determinism: a second launch of each grouped pass gives the same bits
    again = [*sp.splash_attention_fwd(q, k, v, tables),
             sp.splash_attention_bwd_dq(*bwd_args, tables),
             *sp.splash_attention_bwd_dkdv(*bwd_args, tables)]
    deterministic = all(torch.equal(a, b) for a, b in zip((o, lse, dq, dk, dv), again))
    del o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref, exact, ex, got, again
    free_memory()
    second = _splash_second_passes(q, k, v, bwd_args, tables)
    flex = _flex_times(q, k, v, do, layout_mask_mod(layout, block))
    free_memory()
    mask = torch.from_numpy(layout_to_mask(layout, block)).cuda()[None]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask)

    sdpa_fwd = time_ms(lambda: sdpa(q, k, v), iters=5)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, do),
                       iters=5) - sdpa_fwd
    del mask, leaves
    free_memory()

    # operations per active (q-block, k-block) pair of a (batch, head) row:
    # 4·D (fwd), 6·D (dq), 8·D (dk/dv) per (query, key) pair in it; bytes:
    # each input read once, each output written once, and each pass's plan
    # (the forward's for dq)
    active = int(layout.sum()) * (B * H // layout.shape[0])
    pairs = active * block * block
    qb, rb = B * H * S * D * 2, B * H * S * 4
    work = {"fwd": (4, 4 * qb + rb + splash_plan_bytes(tables.plan)),
            "dq": (6, 5 * qb + 2 * rb + splash_plan_bytes(tables.plan)),
            "dkdv": (8, 6 * qb + 2 * rb + splash_plan_bytes(tables.plan_t))}
    timed = {
        "fwd": (lambda: sp.splash_attention_fwd(q, k, v, tables),
                lambda: sp.splash_attention_fwd_reference(q, k, v, layout, block),
                flex["fwd"], sdpa_fwd),
        "dq": (lambda: sp.splash_attention_bwd_dq(*bwd_args, tables),
               lambda: sp.splash_attention_bwd_dq_reference(*bwd_args, layout, block),
               flex["bwd"], sdpa_bwd),
        "dkdv": (lambda: sp.splash_attention_bwd_dkdv(*bwd_args, tables),
                 lambda: sp.splash_attention_bwd_dkdv_reference(*bwd_args, layout, block),
                 flex["bwd"], sdpa_bwd),
    }
    counts = np.asarray(layout).astype(bool).sum(2)  # each row's active blocks
    rec = {"case": name, "shape": {**SPLASH_SHAPE, "block": block, "layout": config,
                                   "layout_heads": int(layout.shape[0])},
           "active_blocks": active, "dtype": "bfloat16", "lse_max_abs_err": lse_err,
           "lse_empty_rows_marked": lse_empty_ok, "deterministic": deterministic,
           "k8_path": SPLASH_PATHS,
           "plan": {"fwd": splash_plan_record(tables.plan),
                    "dkdv": splash_plan_record(tables.plan_t)},
           "widest_row": int(counts.max()), "widest_transposed_row":
               int(np.asarray(layout).astype(bool).sum(1).max()),
           "mean_row": float(np.mean(counts)),
           "splash_flops": splash_flops(layout, block, D, batch=B), **second}
    for key, (kernel, plain, flex_ms, sdpa_ms) in timed.items():
        flops = work[key][0] * D * pairs
        bound_flops = flops / BF16_FLOPS * 1e3
        bound_bytes = work[key][1] / HBM_BYTES_PER_S * 1e3
        rec[key] = {**errs[key], "tolerance": FLASH_ROW_TOL["bfloat16"],
                    # the card's time from a graph; events around calls
                    # through the wrapper show its host cost beside it
                    "ms": graph_time_ms(kernel), "events_ms": time_ms(kernel),
                    "plain_ms": time_ms(plain, iters=3),
                    # flex's and SDPA's backward compute dq, dk and dv in one
                    # call: the same time stands beside both backward passes
                    "library_ms": flex_ms, "library": "flex_attention (compiled, BlockMask)",
                    "sdpa_ms": sdpa_ms, "gflop": flops / 1e9,
                    "bound_ms": max(bound_flops, bound_bytes),
                    "bound_by": "operations" if bound_flops >= bound_bytes else "bytes"}
    del q, k, v, do, delta, bwd_args, timed, tables
    free_memory()
    return rec


# the tiles' crossover: tokens N per sequence (folded rows N * G per
# sequence and KV head) at each serving family's widths and options, 8
# sequences at its phase-2 decode histories: BLOOM-7B1 (G 1, ALiBi),
# Gemma-2-9B (G 2, the cap, global layers), Llama-3-8B (G 4) and
# StarCoder2-7B (G 9, its window); 8 to 64 rows, and every count from 16
# to 24 that G reaches (at G 2, whose head width takes 33, 34 and 40 too)
CROSSOVER_N = {1: (8, 16, 17, 20, 24, 32, 48, 64), 2: (4, 8, 9, 10, 12, 16, 17, 20, 24, 32),
               4: (2, 4, 5, 6, 8, 12, 16), 9: (1, 2, 3, 4, 5, 7)}


def crossover_sweep(gen) -> dict:
    """K4's wgmma tiles against its decode kernel (``run_kernel`` names
    each) at CROSSOVER_N tokens a sequence, each launch graph-timed and held
    row by row against the plain version as the phase's K4 cases are (one
    bf16 rounding of the exact value + 2^-8); ``tiles_win_from`` is, at each
    G, the fewest swept rows from which the tiles are as fast at every
    larger count, beside the plan's wgmma_min_rows(D)."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import (paged_attention_reference,
                                                         run_kernel, wgmma_min_rows)
    points, ok = [], True
    for widths, seen, B, opts in (
            (BLOOM_PAGED, [2048 + 5, 1536 + 9, 1024 + 13, 1024 + 17, 512 + 21, 256 + 25,
                           128 + 29, 128 + 31], 34, {"alibi": True}),
            (GEMMA2_PAGED, [5120 + 5, 4864 + 9, 4352 + 13, 3072 + 17, 2048 + 21, 1024 + 25,
                            512 + 29, 128 + 31], 82,
             {"softcap": GEMMA2_ATTN_CAP, "q_scale": CAP_Q_SCALE}),
            (LLAMA_PAGED, [128 * (i + 1) + 22 for i in range(8)], 17, {}),
            (SC2_PAGED, [4200, 4608, 5000, 5184, 6000, 4095, 8000, 300], 126,
             {"window": SC2_WINDOW})):
        G = widths["G"]
        for N in CROSSOVER_N[G]:
            args, kw = _paged_inputs(gen, seen, [N] * 8, N, B, widths=widths, **opts)
            ref = paged_attention_reference(*args, **kw)
            exact = paged_attention_reference(args[0].float(), *args[1:], **kw)
            rounding = row_rel_err(exact.to(torch.bfloat16), exact)
            point = {"G": G, "N": N, "rows": N * G,
                     "options": sorted(k for k in opts if k != "q_scale")}
            for kernel in ("wgmma", "decode"):
                err = row_rel_err(run_kernel(kernel, *args, **kw), ref)
                ok &= err <= rounding + PAGED_ROW_SLACK
                point[kernel + "_row_rel_err"] = err
                point[kernel + "_ms"] = graph_time_ms(lambda: run_kernel(kernel, *args, **kw))
            points.append(point)
            del args, ref, exact
            torch.cuda.empty_cache()
    wins = {}
    for G in sorted({p["G"] for p in points}):
        mine = [p for p in points if p["G"] == G]
        wins[f"G{G}"] = next((p["rows"] for i, p in enumerate(mine)
                              if all(q["wgmma_ms"] <= q["decode_ms"] for q in mine[i:])), None)
    return {"timing": "cuda graph", "points": points, "ok": ok, "tiles_win_from": wins,
            "wgmma_min_rows": {f"D{D}": wgmma_min_rows(D) for D in (128, 256)}}


# the fp32-query kernels' crossover: tokens N per sequence (folded rows N *
# G) at the widths of the fp32 engines' families over an fp32 cache, 8
# sequences at their phase-2 decode histories: Gemma-2-9B (G 2, D 256, the
# cap, global layers) and Llama-3-8B (G 4, D 128); 2 to 64 rows, and the
# first count past the plan's 33 at each
F32_CROSSOVER_N = {2: (1, 4, 8, 12, 16, 17, 20, 24, 32), 4: (1, 2, 4, 6, 8, 9, 12, 16)}


def f32_crossover_sweep(gen) -> dict:
    """K4's fp32 chunk kernel against its fp32 decode kernel (``run_kernel``
    names each) at F32_CROSSOVER_N tokens a sequence, each launch
    graph-timed and held as the phase's fp32 cases are (the largest row
    error 2^-14); ``chunk_wins_from`` is, at each G, the
    fewest swept rows from which the chunk kernel is as fast at every
    larger count, beside the plan's f32_chunk_min_rows()."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import (f32_chunk_min_rows,
                                                         paged_attention_reference, run_kernel)
    points, ok = [], True
    for widths, seen, B, opts in (
            (GEMMA2_PAGED, [5120 + 5, 4864 + 9, 4352 + 13, 3072 + 17, 2048 + 21, 1024 + 25,
                            512 + 29, 128 + 31], 82,
             {"softcap": GEMMA2_ATTN_CAP, "q_scale": CAP_Q_SCALE}),
            (LLAMA_PAGED, [128 * (i + 1) + 22 for i in range(8)], 17, {})):
        G = widths["G"]
        for N in F32_CROSSOVER_N[G]:
            args, kw = _paged_inputs(gen, seen, [N] * 8, N, B, widths=widths,
                                     dtype=torch.float32, **opts)
            ref = paged_attention_reference(*args, **kw)
            point = {"G": G, "D": widths["D"], "N": N, "rows": N * G,
                     "options": sorted(k for k in opts if k != "q_scale")}
            for kernel in ("fp32 chunk", "fp32 decode"):
                y = run_kernel(kernel, *args, **kw)
                err, abs_err = row_rel_err(y, ref), (y - ref).abs().max().item()
                ok &= err <= FP32_PAGED_ROW_TOL
                key = kernel.replace(" ", "_")
                point[key + "_row_rel_err"] = err
                point[key + "_max_abs_err"] = abs_err
                point[key + "_ms"] = graph_time_ms(lambda: run_kernel(kernel, *args, **kw))
            points.append(point)
            del args, ref, y
            torch.cuda.empty_cache()
    wins = {}
    for G in sorted({p["G"] for p in points}):
        mine = [p for p in points if p["G"] == G]
        wins[f"G{G}"] = next((p["rows"] for i, p in enumerate(mine)
                              if all(q["fp32_chunk_ms"] <= q["fp32_decode_ms"]
                                     for q in mine[i:])), None)
    return {"timing": "cuda graph", "points": points, "ok": ok, "chunk_wins_from": wins,
            "f32_chunk_min_rows": f32_chunk_min_rows()}


def phase_kernels() -> list:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # serving_speculative's cases draw from a generator of their own, so
    # that every earlier case keeps its inputs
    gen_spec = torch.Generator(device="cuda")
    gen_spec.manual_seed(21)
    rms = [_rms_case(8, 4096, gen), _rms_case(768, 4096, gen)]
    # serving_speculative's verify windows: the fused window's 8 x 5 rows,
    # the per-token window put's 64 (8 x 5 bucketed) and the sampled
    # windows' 8 x 4
    rms += [_rms_case(rows, 4096, gen_spec) for rows in (40, 64, 32)]
    # Gemma-2's serving norm: bf16 rows with the fp32 scale 1 + w, at a
    # decode step's 8 rows and a 768-row prefill chunk of hidden 3584
    rms_fp32 = [_rms_case(8, 3584, gen, fp32_scale=True),
                _rms_case(768, 3584, gen, fp32_scale=True)]
    paged_cases = [
        # mixed batch: six decode rows at histories 100..999, a
        # 16-token prefill chunk after 300 seen tokens, one padding row
        _paged_case(gen, "mixed", [100, 250, 400, 550, 700, 999, 300, 0],
                    [1, 1, 1, 1, 1, 1, 16, 0], N=16, B=16),
        # a decode step of generate's 8 sequences (N=1)
        _paged_case(gen, "decode", [128 * (i + 1) + 22 for i in range(8)],
                    [1] * 8, N=1, B=17, graph=True),
        # generate's first admission wave: 3 prompts in a 512-row bucket
        _paged_case(gen, "prefill", [0, 0, 0, 0], [128, 256, 384, 0],
                    N=512, B=8),
        # a chunk of 100 tokens (400 folded rows: three 128-row tiles and
        # 16) beside a padding sequence and a decode row
        _paged_case(gen, "ragged_chunk", [300, 0, 77], [100, 0, 1], N=100, B=7),
    ]
    paged = paged_cases[0]
    ln = [_ln_case(768, 4608, gen, torch.bfloat16), _ln_case(8, 4608, gen, torch.bfloat16),
          _ln_case(37, 100, gen, torch.float32)]
    # the card's floor for one launch, beside the decode-row norms
    floor_ms = launch_floor_ms()
    # StarCoder2-7B widths, window 4096: a decode step of 8 sequences, 7
    # past the window (freed entries in their tables), and a 768-row
    # prefill chunk straddling the window's edge, each over both caches
    window_kw = dict(widths=SC2_PAGED, window=SC2_WINDOW)
    decode_seen = [4200, 4608, 5000, 5184, 6000, 4095, 8000, 300]
    paged_window_cases = [
        _paged_case(gen, "window_decode", decode_seen, [1] * 8, N=1, B=126, graph=True,
                    **window_kw),
        _paged_case(gen, "window_chunk", [3700], [768], N=768, B=84, **window_kw),
        _paged_case(gen, "window_decode", decode_seen, [1] * 8, N=1, B=126, graph=True,
                    int8=True, **window_kw),
        _paged_case(gen, "window_chunk", [3700], [768], N=768, B=84, int8=True,
                    **window_kw),
    ]
    paged_int8_cases = [
        _paged_case(gen, "mixed", [100, 250, 400, 550, 700, 999, 300, 0],
                    [1, 1, 1, 1, 1, 1, 16, 0], N=16, B=16, int8=True),
        _paged_case(gen, "decode", [128 * (i + 1) + 22 for i in range(8)],
                    [1] * 8, N=1, B=17, graph=True, int8=True),
        _paged_case(gen, "prefill", [0, 0, 0, 0], [128, 256, 384, 0],
                    N=512, B=8, int8=True),
        # phase 7's chunk: 768 tokens deep in the cache (2200 seen)
        _paged_case(gen, "chunk_deep", [2200], [768], N=768, B=47, int8=True),
    ]
    # Llama-3-8B's layer kernels (q/o, k/v, gate/up, down), a ragged tail
    # and all-zero blocks
    quant_cases = [_quant_case(gen, "q_proj/o_proj", (4096, 4096)),
                   _quant_case(gen, "k_proj/v_proj", (4096, 1024)),
                   _quant_case(gen, "gate_proj/up_proj", (4096, 14336)),
                   _quant_case(gen, "down_proj", (14336, 4096)),
                   _quant_case(gen, "ragged_tail", (4096 * 3 + 100, )),
                   _quant_case(gen, "zero_blocks", (4096, 1024), zero_block=True)]
    dequant = _dequant_case(gen, (4096, 14336))
    flash_cases = [
        _flash_case(gen, "main", 2, 2048, True),          # the training phase's shape
        _flash_case(gen, "ragged_s1000", 2, 1000, True),  # S not a tile multiple
        _flash_case(gen, "full_s1000", 1, 1000, False),   # no causal mask
        # the training_mistral phase's shape, with Mistral's window and
        # without it (what the window saves)
        _flash_case(gen, "mistral_window", 1, MISTRAL_S, True, window=MISTRAL_WINDOW),
        _flash_case(gen, "causal_s8192", 1, MISTRAL_S, True),
        _flash_case(gen, "main_softcap", 2, 2048, True, softcap=FLASH_SOFTCAP),
    ]
    # K3 at the training phase's shape, at the Mistral phase's and with the
    # softcap
    folded_cases = [
        _flash_case(gen, "main", 2, 2048, True, layout="folded"),
        _flash_case(gen, "mistral_window", 1, MISTRAL_S, True, window=MISTRAL_WINDOW,
                    layout="folded"),
        _flash_case(gen, "main_softcap", 2, 2048, True, softcap=FLASH_SOFTCAP,
                    layout="folded"),
    ]
    # the fp16 instance at the training phase's shape (fp16 training)
    flash_fp16 = [_flash_case(gen, "main_fp16", 2, 2048, True, torch.float16)]
    # K8 under the reference's three default layouts at block 16, and at
    # block 64
    splash_cases = [_splash_case(gen, name, config, block)
                    for name, config, block in SPLASH_LAYOUTS]
    # K4's ALiBi instance at BLOOM-7B1's widths: a decode step of the
    # serving phase's 8 sequences, and a 768-row prefill chunk
    alibi_kw = dict(widths=BLOOM_PAGED, alibi=True)
    bloom_seen = [2048 + 5, 1536 + 9, 1024 + 13, 1024 + 17, 512 + 21, 256 + 25, 128 + 29,
                  128 + 31]
    paged_alibi_cases = [
        _paged_case(gen, "alibi_decode", bloom_seen, [1] * 8, N=1, B=33, graph=True,
                    **alibi_kw),
        _paged_case(gen, "alibi_prefill_chunk", [768], [768], N=768, B=24, **alibi_kw),
        _paged_case(gen, "alibi_decode", bloom_seen, [1] * 8, N=1, B=33, graph=True,
                    int8=True, **alibi_kw),
    ]
    # K4's softcap instance at Gemma-2-9B's widths (H 16, KV 8, D 256, cap
    # 50, queries scaled so that the cap bites): a decode step of the
    # serving phase's 8 sequences through the page split, without and with
    # the window 4096, over both caches; a 768-row prefill chunk
    # straddling the window's edge
    gemma_seen = [5120 + 5, 4864 + 9, 4352 + 13, 3072 + 17, 2048 + 21, 1024 + 25, 512 + 29,
                  128 + 31]
    cap_kw = dict(widths=GEMMA2_PAGED, softcap=GEMMA2_ATTN_CAP, q_scale=CAP_Q_SCALE)
    paged_softcap_cases = [
        _paged_case(gen, "softcap_decode", gemma_seen, [1] * 8, N=1, B=82, graph=True,
                    **cap_kw),
        _paged_case(gen, "softcap_decode_window", gemma_seen, [1] * 8, N=1, B=82,
                    graph=True, window=GEMMA2_WINDOW, **cap_kw),
        _paged_case(gen, "softcap_decode", gemma_seen, [1] * 8, N=1, B=82, graph=True,
                    int8=True, **cap_kw),
        _paged_case(gen, "softcap_decode_window", gemma_seen, [1] * 8, N=1, B=82,
                    graph=True, window=GEMMA2_WINDOW, int8=True, **cap_kw),
        _paged_case(gen, "softcap_chunk_window", [3700], [768], N=768, B=70,
                    window=GEMMA2_WINDOW, **cap_kw),
    ]
    # K4's fp32-query kernels at their main path's shapes: fp32 queries over
    # an fp32 cache, as serving_gemma2's fp32 engine runs them (Gemma-2's
    # decode step with the cap; its 768-row chunk at 3700 deep on a global
    # layer and on a window layer), and fp32 queries over an int8 cache at
    # Llama's decode step, whose pages the plan splits, and at its 768-row
    # chunk 2200 deep; the CUDA-core kernel, which no main path runs, on
    # Gemma-2's fp32 decode step (drawn from a generator of their own,
    # which leaves the later cases' inputs as they were)
    gen32 = torch.Generator(device="cuda")
    gen32.manual_seed(1)
    llama_seen = [128 * (i + 1) + 22 for i in range(8)]
    paged_fp32_cases = [
        _paged_case(gen32, "softcap_decode_fp32", gemma_seen, [1] * 8, N=1, B=82, graph=True,
                    dtype=torch.float32, **cap_kw),
        _paged_case(gen32, "decode_fp32_int8", llama_seen, [1] * 8, N=1, B=17, graph=True,
                    int8=True, dtype=torch.float32),
        _paged_case(gen32, "softcap_chunk_fp32", [3700], [768], N=768, B=70,
                    dtype=torch.float32, **cap_kw),
        _paged_case(gen32, "softcap_chunk_window_fp32", [3700], [768], N=768, B=70,
                    window=GEMMA2_WINDOW, dtype=torch.float32, **cap_kw),
        _paged_case(gen32, "chunk_deep_fp32_int8", [2200], [768], N=768, B=47, int8=True,
                    dtype=torch.float32),
    ]
    paged_cuda_core_cases = [
        _paged_case(gen32, "softcap_decode_fp32", gemma_seen, [1] * 8, N=1, B=82, graph=True,
                    dtype=torch.float32, kernel="cuda cores", **cap_kw),
    ]
    # serving_speculative's shapes at the Llama-3-8B widths: the verify
    # window of 8 sequences about 1100 deep at d 4 (N 5: 20 folded rows,
    # the tiles) and d 2 (N 3: 12 rows, the decode kernel), each also
    # through the other kernel (run_kernel), and an adopting put: 8 tails
    # of 128 tokens at seq_seen 2048 whose tables share their first 32
    # pages
    spec_seen = [1100 + 7 * i for i in range(8)]
    paged_spec_cases = [
        _paged_case(gen_spec, f"verify_n{n}", spec_seen, [n] * 8, N=n, B=18, graph=True,
                    kernel=kernel)
        for n in (SPEC_DRAFTS + 1, 3) for kernel in (None, "decode" if n > 3 else "wgmma")]
    paged_spec_cases.append(
        _paged_case(gen_spec, "adopting_put", [SPEC_PREFIX] * 8, [128] * 8, N=128, B=34,
                    widths=dict(LLAMA_PAGED, n_pages=288), shared_pages=SPEC_PREFIX // 64))
    # K1/K2 at head width 256 (Gemma-2-9B: H 16, KV 8, D 256, cap 50, q
    # scaled so that it bites) over the training phase's S 8192: causal with
    # the window 4096 (the even layers) and causal alone (the odd ones); the
    # fp16 instance and K3 at the window's shape
    d256_kw = dict(widths=(16, 8, 256), softcap=GEMMA2_ATTN_CAP, q_scale=CAP_Q_SCALE)
    flash_d256 = [
        _flash_case(gen, "gemma2_window", 1, MISTRAL_S, True, window=GEMMA2_WINDOW,
                    **d256_kw),
        _flash_case(gen, "gemma2_causal", 1, MISTRAL_S, True, **d256_kw),
    ]
    flash_d256_fp16 = [_flash_case(gen, "gemma2_window_fp16", 1, MISTRAL_S, True,
                                   torch.float16, window=GEMMA2_WINDOW, **d256_kw)]
    folded_d256 = [_flash_case(gen, "gemma2_window", 1, MISTRAL_S, True,
                               window=GEMMA2_WINDOW, layout="folded", **d256_kw)]
    # the other D-256 instances (per-head fp32; folded fp16 and fp32) at S
    # 2048 under a 512 window, flex_attention in their dtype beside them
    other_kw = dict(window=512, **d256_kw)
    flash_d256_fp32 = [_flash_case(gen, "gemma2_float32_s2048", 1, 2048, True,
                                   torch.float32, **other_kw)]
    folded_d256_fp16, folded_d256_fp32 = (
        [_flash_case(gen, f"gemma2_{str(dtype)[6:]}_s2048", 1, 2048, True, dtype,
                     layout="folded", **other_kw)] for dtype in (torch.float16, torch.float32))
    # K7: each body at one layer's parameters and at a ragged tail; the
    # whole LAMB step over the layer's 9 tensors
    k7_cases = [_k7_case(gen, body, n) for body in ("adamw", "adam_l2", "lion", "lamb_pass")
                for n in (LAYER_PARAMS, K7_TAIL)]
    k7_cases += [_k7_case(gen, "lamb_step", LAYER_PARAMS)]
    all_paged = (paged_cases + paged_int8_cases + paged_window_cases + paged_alibi_cases
                 + paged_softcap_cases + paged_fp32_cases + paged_cuda_core_cases
                 + paged_spec_cases)
    paged_ok = [c.get("staged_row_rel_err", c["row_rel_err"])
                <= c["rounding_row_rel_err"] + PAGED_ROW_SLACK
                and c.get("control_max_abs_err", c["max_abs_err"]) <= PAGED_TOL
                and ("control_row_rel_err" not in c
                     or c["row_rel_err"] <= c["control_row_rel_err"] + PAGED_ROW_SLACK)
                and c.get("round_p_excess", 0.0) <= 0.0
                and c.get("fp32_row_rel_err", 0.0) <= FP32_PAGED_ROW_TOL
                for c in all_paged]
    # the K4 cases that ran the multi-row tiles on wgmma (every prefill
    # chunk and wave, and the mixed batch: 16 rows of G 4), those that ran
    # the bf16 decode kernel (every bf16 decode step) and those that ran
    # the fp32 chunk and decode kernels (the fp32 queries)
    wgmma_paged = [c for c in all_paged if c["path"] == "wgmma"]
    decode_paged = [c for c in all_paged if c["path"] == "decode"]
    f32_chunk_paged = [c for c in all_paged if c["path"] == "fp32 chunk"]
    f32_decode_paged = [c for c in all_paged if c["path"] == "fp32 decode"]
    # the plan's rule (head widths 128 and 256 here), or the named kernel;
    # the int8 fp32 decode case must split its pages
    paths_ok = all(c["path"] == (c["forced"] or k4_expected_path(c["shape"]))
                   for c in all_paged) and \
        all(c["path"] == "decode" for c in all_paged
            if c["shape"]["N"] == 1 and c["shape"]["dtype"] == "bfloat16") and \
        [c["path"] for c in paged_fp32_cases] == ["fp32 decode"] * 2 + ["fp32 chunk"] * 3 and \
        paged_cuda_core_cases[0]["path"] == "cuda cores" and \
        paged_fp32_cases[1]["split_pages"] < paged_fp32_cases[1]["shape"]["B"] and \
        [c["path"] for c in paged_spec_cases] == ["wgmma", "decode", "decode", "wgmma", "wgmma"]
    crossover = crossover_sweep(gen)
    f32_crossover = f32_crossover_sweep(gen32)
    d256_cases = (flash_d256 + flash_d256_fp16 + flash_d256_fp32 + folded_d256
                  + folded_d256_fp16 + folded_d256_fp32)
    all_flash = flash_cases + flash_fp16 + folded_cases + d256_cases
    ok = all(c["max_abs_err"] <= RMS_TOL for c in rms + rms_fp32) and \
        all(c["cap_bite_share"] >= CAP_BITES for c in paged_softcap_cases + d256_cases) and \
        all(c["max_abs_err"] <= c["tolerance"] for c in ln) and all(paged_ok) and paths_ok and \
        crossover["ok"] and \
        f32_crossover["ok"] and \
        all(c["equal"] for c in quant_cases) and dequant["equal"] and \
        quant_cases[-1]["zero_block_scales"] == [1.0, 1.0] and \
        all(c[key]["row_rel_err"] <= c["row_tolerance"]
            and c["lse_max_abs_err"] <= LSE_TOL
            and c[key]["vs_exact"]["kernel"] <= FLASH_EXACT_RATIO * c[key]["vs_exact"]["plain"]
            for c in all_flash for key, _, _ in FLASH_KERNELS) and \
        all(c[key]["row_rel_err"] <= FLASH_ROW_TOL[c["dtype"]]
            and c["lse_max_abs_err"] <= LSE_TOL and c["lse_empty_rows_marked"]
            and c[key]["vs_exact"]["kernel"] <= FLASH_EXACT_RATIO * c[key]["vs_exact"]["plain"]
            for c in splash_cases for key, _, _ in SPLASH_KERNELS) and \
        all(c["deterministic"] for c in splash_cases) and \
        all(any(c[key] for c in splash_cases) for key, *_ in SPLASH_SECOND) and \
        all(c[key]["row_rel_err"] <= FLASH_ROW_TOL["bfloat16"]
            and c[key].get("lse_max_abs_err", 0.0) <= LSE_TOL
            for c in splash_cases for key, *_ in SPLASH_SECOND if c[key]) and \
        all(c["max_ulps"] <= K7_ULPS for c in k7_cases)
    main = rms[1]
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cuh",
         "replaces": "deepspeed_tpu/ops/paged_attention.py:60",
         "launches": None, "tolerance": PAGED_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in paged_cases),
         "row_rel_err": max(c["row_rel_err"] for c in paged_cases),
         **{k: paged[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
         "cases": paged_cases,
         "spec_cases": paged_spec_cases},
        {"name": "paged_attention_int8", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cuh",
         "replaces": "deepspeed_tpu/ops/paged_attention.py:111",
         "launches": None,
         "tolerance": "against the plain version on the staged bf16 K/V: as "
                      "paged_attention; against the plain version, the largest row "
                      "error ||kernel - plain|| / ||plain|| <= the staged version's + 2^-8",
         "max_abs_err": max(c["max_abs_err"] for c in paged_int8_cases),
         "row_rel_err": max(c["row_rel_err"] for c in paged_int8_cases),
         **{k: paged_int8_cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
         "cases": paged_int8_cases},
        {"name": "paged_attention_alibi", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cuh",
         "replaces": "deepspeed_tpu/ops/paged_attention.py:125",
         "launches": None, "tolerance": PAGED_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in paged_alibi_cases),
         "row_rel_err": max(c["row_rel_err"] for c in paged_alibi_cases),
         **{k: paged_alibi_cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
         "cases": paged_alibi_cases},
        {"name": "paged_attention_window", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cuh",
         "replaces": "deepspeed_tpu/ops/paged_attention.py:87-106",
         "launches": None,
         "tolerance": "bf16 cache: as paged_attention; int8 cache: as "
                      "paged_attention_int8",
         "max_abs_err": max(c["max_abs_err"] for c in paged_window_cases),
         "row_rel_err": max(c["row_rel_err"] for c in paged_window_cases),
         **{k: paged_window_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
         "cases": paged_window_cases},
        {"name": "paged_attention_wgmma", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention_wgmma_bf16.cu",
         "sources": ["deepspeed_tpu_torch/csrc/paged_attention_wgmma_bf16.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention_wgmma_bf16_d256.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention_wgmma_int8.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention_wgmma_int8_d256.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention.cuh",
                     "deepspeed_tpu_torch/csrc/flash_attention.cuh"],
         "replaces": "deepspeed_tpu/ops/paged_attention.py:60",
         "note": "K4's multi-row tiles (>= 17 folded rows N * G per sequence and KV head, "
                 "33 past head width 128, "
                 "bf16 queries) on wgmma; every K4 case above that ran it (its path)",
         "launches": None, "tolerance": PAGED_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in wgmma_paged),
         "row_rel_err": max(c["row_rel_err"] for c in wgmma_paged),
         **{k: paged_cases[2][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
         "cases": wgmma_paged},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_decode.cuh",
         "sources": ["deepspeed_tpu_torch/csrc/paged_decode_bf16.cu",
                     "deepspeed_tpu_torch/csrc/paged_decode_bf16_d256.cu",
                     "deepspeed_tpu_torch/csrc/paged_decode_int8.cu",
                     "deepspeed_tpu_torch/csrc/paged_decode_int8_d256.cu",
                     "deepspeed_tpu_torch/csrc/paged_decode.cuh",
                     "deepspeed_tpu_torch/csrc/paged_attention.cuh"],
         "replaces": "deepspeed_tpu/ops/paged_attention.py:60",
         "note": "K4's decode kernel (bf16 queries under the tiles' rows, D % 16 == 0) on "
                 "mma.sync with warps splitting the keys and a cp.async ring; every K4 case "
                 "above that ran it (its path)",
         "launches": None, "tolerance": PAGED_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in decode_paged),
         "row_rel_err": max(c["row_rel_err"] for c in decode_paged),
         **{k: paged_cases[1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
         "cases": decode_paged, "crossover": crossover},
        {"name": "paged_attention_f32_chunk", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_f32.cuh",
         "sources": F32_SOURCES,
         "replaces": "deepspeed_tpu/ops/paged_attention.py:60",
         "note": "K4's fp32-query chunk kernel (fp32 queries over an fp32 or int8 cache, "
                 ">= f32_chunk_min_rows() folded rows): register-blocked FFMA products, a "
                 "cp.async ring; its launches are the prefill chunks of serving_gemma2's "
                 "fp32 engine; the main case is Gemma-2's 768-row chunk on a global layer",
         "launches": None, "tolerance": F32_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in f32_chunk_paged),
         "row_rel_err": max(c["row_rel_err"] for c in f32_chunk_paged),
         **{k: paged_fp32_cases[2][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
         "cases": f32_chunk_paged, "crossover": f32_crossover},
        {"name": "paged_attention_f32_decode", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_f32.cuh",
         "sources": F32_SOURCES,
         "replaces": "deepspeed_tpu/ops/paged_attention.py:60",
         "note": "K4's fp32-query decode kernel (under f32_chunk_min_rows() folded rows): "
                 "the warps split every key tile, a cp.async ring, lean splits; its "
                 "launches are the decode steps of serving_gemma2's fp32 engine",
         "launches": None, "tolerance": F32_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in f32_decode_paged),
         "row_rel_err": max(c["row_rel_err"] for c in f32_decode_paged),
         **{k: paged_fp32_cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
         "cases": f32_decode_paged},
        {"name": "paged_attention_cuda_cores", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cuh",
         "sources": ["deepspeed_tpu_torch/csrc/paged_attention_f32.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention_bf16.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention_int8_f32.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention_int8_bf16.cu",
                     "deepspeed_tpu_torch/csrc/paged_attention.cuh"],
         "replaces": "deepspeed_tpu/ops/paged_attention.py:60",
         "note": "K4's CUDA-core kernel: what the other kernels do not take (bf16 queries at "
                 "widths the tiles and the decode kernel refuse, fp32 queries at D % 4 != 0; "
                 "no model of the repo has such a width), P rounded to bf16 over bf16-staged "
                 "K/V; no main path launches it (serving_gemma2's fp32 engine counts 0); held "
                 "here on Gemma-2's fp32 decode step through run_kernel",
         "launches": None, "tolerance": F32_TOLERANCE,
         "max_abs_err": max(c["max_abs_err"] for c in paged_cuda_core_cases),
         "row_rel_err": max(c["row_rel_err"] for c in paged_cuda_core_cases),
         **{k: paged_cuda_core_cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
         "cases": paged_cuda_core_cases},
        {"name": "quantize_int8_blockwise", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/quantizer.cu",
         "replaces": "deepspeed_tpu/ops/quantizer.py:29",
         "launches": None, "tolerance": "bit for bit",
         "max_abs_err": max(c["max_abs_err"] for c in quant_cases),
         **{k: quant_cases[2][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
         "cases": quant_cases},
        {"name": "dequantize_int8_blockwise", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/quantizer.cu",
         "replaces": "deepspeed_tpu/ops/quantizer.py:83",
         "note": "no TPU kernel: XLA fuses this jnp expression into its matmul",
         "launches": None, "tolerance": "bit for bit",
         **{k: dequant[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         "cases": [dequant]},
        {"name": "rms_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/row_norm.cuh",
         "replaces": "deepspeed_tpu/ops/normalization.py:26",
         "note": "built in csrc/rms_norm.cu; launch_floor_ms: an empty kernel's graph time, "
                 "the card's floor for one launch (the bound stays the bytes')",
         "launches": None, "tolerance": RMS_TOL, "launch_floor_ms": floor_ms,
         "max_abs_err": max(c["max_abs_err"] for c in rms),
         **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
         "cases": rms},
        {"name": "rms_norm_fp32_scale", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/row_norm.cuh",
         "replaces": "deepspeed_tpu/ops/normalization.py:26",
         "note": "bf16 rows, fp32 scale (Gemma's 1 + w); the JAX kernel casts any scale; "
                 "built in csrc/rms_norm.cu",
         "launches": None, "tolerance": RMS_TOL, "launch_floor_ms": floor_ms,
         "max_abs_err": max(c["max_abs_err"] for c in rms_fp32),
         **{k: rms_fp32[1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
         "cases": rms_fp32},
        {"name": "paged_attention_softcap", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cuh",
         "replaces": "deepspeed_tpu/ops/paged_attention.py:122",
         "launches": None,
         "tolerance": "bf16 cache: as paged_attention; int8 cache: as paged_attention_int8; "
                      f"each case's cap_bite_share >= {CAP_BITES}",
         "max_abs_err": max(c["max_abs_err"] for c in paged_softcap_cases),
         "row_rel_err": max(c["row_rel_err"] for c in paged_softcap_cases),
         **{k: paged_softcap_cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")},
         "cases": paged_softcap_cases},
        {"name": "layer_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/row_norm.cuh",
         "replaces": "deepspeed_tpu/ops/normalization.py:32",
         "note": "built in csrc/layer_norm.cu",
         "launches": None, "tolerance": LN_TOL, "launch_floor_ms": floor_ms,
         "max_abs_err": max(c["max_abs_err"] for c in ln),
         **{k: ln[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "cases": ln},
    ] + [
        {"name": name, "route": "cuda", "source": flash_source("per_head", key),
         "replaces": replaces, "launches": None,
         "tolerance": "largest row error ||kernel - plain|| / ||plain|| <= 2^-6; "
                      "against the exact fp64 value at most 2x the plain version's",
         "max_abs_err": max(c[key]["max_abs_err"] for c in flash_cases),
         "row_rel_err": max(c[key]["row_rel_err"] for c in flash_cases),
         **{k: flash_cases[0][key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
         "cases": [{"case": c["case"], "shape": c["shape"], **c[key]} for c in flash_cases]}
        for key, name, replaces in FLASH_KERNELS] + [
        {"name": name + "_fp16", "route": "cuda",
         "source": flash_source("per_head", key, dtype="float16"),
         "replaces": replaces, "launches": None,
         "tolerance": "largest row error ||kernel - plain|| / ||plain|| <= 2^-8; "
                      "against the exact fp64 value at most 2x the plain version's",
         "max_abs_err": flash_fp16[0][key]["max_abs_err"],
         "row_rel_err": flash_fp16[0][key]["row_rel_err"],
         **{k: flash_fp16[0][key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
         "cases": [{"case": c["case"], "shape": c["shape"], **c[key]} for c in flash_fp16]}
        for key, name, replaces in FLASH_KERNELS] + [
        {"name": name, "route": "cuda", "source": flash_source("folded", key),
         "replaces": replaces, "launches": None,
         "tolerance": "largest row error ||kernel - plain|| / ||plain|| <= 2^-6; "
                      "against the exact fp64 value at most 2x the plain version's",
         "max_abs_err": max(c[key]["max_abs_err"] for c in folded_cases),
         "row_rel_err": max(c[key]["row_rel_err"] for c in folded_cases),
         **{k: folded_cases[0][key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
         "cases": [{"case": c["case"], "shape": c["shape"], **c[key]} for c in folded_cases]}
        for key, name, replaces in FOLDED_KERNELS] + [
        {"name": name + suffix, "route": "cuda",
         "source": flash_source(layout, key, True, dtype),
         "replaces": replaces, "launches": None,
         "tolerance": "largest row error ||kernel - plain|| / ||plain|| <= "
                      + ("2^-14" if suffix.endswith("float32") else "2^-6")
                      + "; against the exact fp64 value at most 2x the plain version's; "
                      f"each case's cap_bite_share >= {CAP_BITES}",
         "max_abs_err": max(c[key]["max_abs_err"] for c in cases),
         "row_rel_err": max(c[key]["row_rel_err"] for c in cases),
         **{k: cases[0][key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
         "cases": [{"case": c["case"], "shape": c["shape"], "dtype": c["dtype"],
                    "cap_bite_share": c["cap_bite_share"],
                    "sdpa_causal_without_cap_ms": c.get("sdpa_causal_without_cap_ms"),
                    **c[key]} for c in cases]}
        for suffix, layout, dtype, cases, table in (
            ("_d256", "per_head", "bfloat16", flash_d256, FLASH_KERNELS),
            ("_d256_fp16", "per_head", "float16", flash_d256_fp16, FLASH_KERNELS),
            ("_d256_float32", "per_head", "float32", flash_d256_fp32, FLASH_KERNELS),
            ("_d256", "folded", "bfloat16", folded_d256, FOLDED_KERNELS),
            ("_d256_float16", "folded", "float16", folded_d256_fp16, FOLDED_KERNELS),
            ("_d256_float32", "folded", "float32", folded_d256_fp32, FOLDED_KERNELS))
        for key, name, replaces in table] + [
        {"name": name, "route": "cuda", "source": SPLASH_SOURCES[key],
         "replaces": replaces, "launches": None,
         "tolerance": "largest row error ||kernel - plain|| / ||plain|| <= 2^-6; "
                      "against the exact fp64 value at most 2x the plain version's; "
                      "lse within 1e-3 on rows that see a key, +1e30 on the others",
         "max_abs_err": max(c[key]["max_abs_err"] for c in splash_cases),
         "row_rel_err": max(c[key]["row_rel_err"] for c in splash_cases),
         **{k: splash_cases[0][key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
         "cases": [{"case": c["case"], "shape": c["shape"], "active_blocks": c["active_blocks"],
                    "widest_row": c["widest_row"],
                    "widest_transposed_row": c["widest_transposed_row"],
                    "k8_path": c["k8_path"][key], "plan": c["plan"].get(key),
                    "deterministic": c["deterministic"], **c[key]}
                   for c in splash_cases]}
        for key, name, replaces in SPLASH_KERNELS] + [
        {"name": name, "route": "cuda", "source": SPLASH_SOURCES[key], "replaces": replaces,
         "launches": None,
         "tolerance": "the split rows within the flash row rule (2^-6) of the plain "
                      "version on the same partials; lse within 1e-3",
         **{k: next(c[key] for c in splash_cases if c[key])[k]
            for k in ("max_abs_err", "row_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms")},
         "cases": [{"case": c["case"], "plan": c["plan"][follows], **c[key]}
                   for c in splash_cases if c[key]]}
        for key, name, follows, replaces in SPLASH_SECOND] + [
        {"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/fused_optimizer.cu",
         "replaces": replaces, "launches": None,
         "tolerance": f"each output within {K7_ULPS} fp32 ulps of the plain version",
         "max_ulps": max(c["max_ulps"] for c in k7_cases if c["case"] in bodies),
         "max_abs_err": max(c["max_abs_err"] for c in k7_cases if c["case"] in bodies),
         **{k: next(c for c in k7_cases if c["case"] == bodies[0])[k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "cases": [c for c in k7_cases if c["case"] in bodies]}
        for name, _, bodies, replaces in K7_KERNELS]
    emit({"phase": "kernels", "ok": ok, "paged_paths_ok": paths_ok, "gpu": gpu_identity(),
          "kernels": kernels})
    if not ok:
        raise SystemExit("kernel mismatch against the plain version")
    return kernels


def phase_parity() -> dict:
    """Whole engine, tiny config, fp32: GPU (kernels) vs CPU (plain); then
    with int8 weights and an int8 KV cache."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    ecfg = dict(num_kv_blocks=64, state_manager=dict(
        max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=128))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (7, 33, 20)]

    def run(**quant):
        engines = [build_llama_engine(
            cfg, params=init_llama(cfg, seed=1, dtype=torch.float32, device="cpu").to(d),
            dtype=torch.float32, kv_block_size=16, device=d,
            engine_config=RaggedInferenceEngineConfig(**ecfg), **quant)
            for d in ("cpu", "cuda")]
        logits = [e.put([0, 1, 2], prompts).float().cpu() for e in engines]
        steps = [e.put([0, 1, 2], [[1], [2], [3]]).float().cpu() for e in engines]
        return max((logits[0] - logits[1]).abs().max().item(),
                   (steps[0] - steps[1]).abs().max().item())

    err = run()
    tol = 1e-3  # fp32 on both sides; kernels sum in another order
    err_int8 = run(quantize="int8", kv_cache_dtype="int8")
    # K6 gives both the same int8 weights; K4 stages each K/V element and
    # scale in bf16 where the CPU's plain version dequantizes in fp32 (the
    # CPU tests read 0.015 between the JAX engine's two int8 paths)
    tol_int8 = 0.05
    rec = {"phase": "parity", "config": "tiny(num_key_value_heads=2) fp32",
           "max_abs_err": err, "tolerance": tol,
           "int8": {"options": 'quantize="int8", kv_cache_dtype="int8"',
                    "max_abs_err": err_int8, "tolerance": tol_int8},
           "ok": err <= tol and err_int8 <= tol_int8}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("GPU engine disagrees with the CPU engine")
    return rec


TRAIN_PARITY_CONFIG = {
    "train_batch_size": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 3,
        "warmup_type": "linear"}},
    "gradient_clipping": 1.0}


# phase 4's configs: the tiny Llama, and the same with a 48-token window on
# every layer (shorter than a 64-key tile and not a multiple of it) and the
# attention-logit softcap, both through K1/K2's options on the card
TRAIN_PARITY_MODELS = {"llama": dict(num_key_value_heads=2),
                       "window48_softcap30": dict(num_key_value_heads=2, sliding_window=48,
                                                  attn_logit_softcapping=30.0),
                       # a tiny Gemma-2: head_dim 256 (the fp32 instances
                       # of K1/K2 at 256), G 2, a 48-token window on layer 0
                       # only, Gemma-2's caps, the sandwich and (1 + w)
                       # norms, the embedding scale, the tanh-gelu gate
                       "gemma2_d256": dict(num_key_value_heads=2, head_dim=256,
                                           sliding_window=48, sliding_window_layers=(0, ),
                                           attn_logit_softcapping=50.0,
                                           final_logit_softcapping=30.0, sandwich_norm=True,
                                           norm_plus_one=True, embed_scale=8.0,
                                           mlp_type="geglu_tanh", tie_word_embeddings=True)}


def phase_train_parity() -> dict:
    """Training engine, tiny configs, fp32, 3 steps: GPU (kernels) vs CPU
    (plain versions) from the same weights and batches."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # fp32 on both sides, sums in another order. Adam's m/sqrt(v) is a
    # ratio: an element whose gradient nearly cancels carries its relative
    # difference into the update, up to the whole step. The parameters are
    # held to 5% of the path the 3 updates can move an element (lr 1e-4 +
    # 4e-4 + 7e-4 = 1.2e-3), the losses to 1e-4 of ~6
    loss_tol, param_tol = 1e-4, 0.05 * 1.2e-3
    configs = {}
    for cname, over in TRAIN_PARITY_MODELS.items():
        cfg = LlamaConfig.tiny(dtype=torch.float32, **over)
        rng = np.random.default_rng(0)
        # S = 100: the kernels' last 64-row tile is ragged
        batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 100)))
                   for _ in range(3)]
        losses, masters, norms = {}, {}, {}
        for device in ("cpu", "cuda"):
            model = init_llama_for_causal_lm(cfg, seed=1, device="cpu")
            engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                        config=TRAIN_PARITY_CONFIG,
                                                        device=device)
            losses[device], norms[device] = [], []
            for ids in batches:
                loss = engine.forward(ids, labels=ids)
                engine.backward(loss)
                engine.step()
                losses[device].append(loss.item())
                norms[device].append(engine.get_global_grad_norm())
            # the loss of the trained weights on the first batch
            losses[device].append(engine.eval_batch(batches[0], labels=batches[0]).item())
            masters[device] = {n: m.cpu() for n, m in engine.master_params().items()}
        loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        param_err = max((masters["cpu"][n] - masters["cuda"][n]).abs().max().item()
                        for n in masters["cpu"])
        configs[cname] = {"config": f"tiny({over}) fp32", "losses_then_eval": losses,
                          "grad_norms": norms, "loss_max_abs_err": loss_err,
                          "param_max_abs_err": param_err,
                          "ok": loss_err <= loss_tol and param_err <= param_tol}
    rec = {"phase": "train_parity", "run": "AdamW + WarmupLR + clip 1.0, 3 steps of "
           "2 x 100 tokens", "configs": configs, "loss_tolerance": loss_tol,
           "param_tolerance": param_tol, "ok": all(c["ok"] for c in configs.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("GPU training engine disagrees with the CPU engine")
    return rec


def _kernel_group(name: str) -> str:
    n = name.lower()
    if is_k7(n):  # launched through ctypes, so under no op of the range
        return "optimizer step"
    if "flash" in n:  # K3 launches these too
        return ("K1 flash fwd" if "::fwd_" in n else
                "K2 flash dq" if "::dq_" in n else "K2 flash dk/dv")
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "matmul")):
        return "matmul (layers)"
    return "other"


def is_k7(kernel_name: str) -> bool:
    n = kernel_name.lower()
    return "optim::" in n and any(b in n for b in ("adam_kernel", "lion_kernel",
                                                   "lamb_kernel"))


def _kernels_under(ev):
    yield from ev.kernels
    for child in ev.cpu_children:
        yield from _kernels_under(child)


# profiler ranges the port opens (ops/chunked_ce.py, runtime/engine.py)
PROFILE_RANGES = {"chunked_ce_forward": "chunked CE (fwd + bwd)",
                  "chunked_ce_backward": "chunked CE (fwd + bwd)",
                  "optimizer_step": "optimizer step"}


def profile_step(step) -> dict:
    """Where one call of ``step`` spends its time: its forward, backward
    and optimizer step on CUDA events (spans on the device's clock, idle
    included), then a ``torch.profiler`` trace of another call with the
    device kernel time summed into groups: the port's named ranges (the
    chunked CE's sweeps, the optimizer step: every kernel under them), the
    flash kernels, the other matmuls, other PyTorch kernels; the wall time
    less the device's busy time is the host's gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    step(events)
    events[3].synchronize()
    split = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("forward_ms", "backward_ms", "step_ms"))}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.monotonic()
        step(None)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t)
    # device kernels only: a range also shows on the device timeline, as a
    # user annotation spanning its kernels
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    in_ranges, groups = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in PROFILE_RANGES:
            for k in _kernels_under(e):
                in_ranges[k.name] = in_ranges.get(k.name, 0.0) + k.duration / 1e3
                g = PROFILE_RANGES[e.name]
                groups[g] = groups.get(g, 0.0) + k.duration / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    for name, ms in by_name.items():  # what no named range holds
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms - in_ranges.get(name, 0.0)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"split": split, "wall_ms": wall_ms, "device_ms": device_ms,
            "k1_kernels": sorted(n for n in by_name if _kernel_group(n) == "K1 flash fwd"),
            "k7_ms": sum(ms for name, ms in by_name.items() if is_k7(name)),
            "device_busy_share": device_ms / wall_ms, "host_gap_ms": wall_ms - device_ms,
            "kernel_launches": len(kernels), "group_ms": groups,
            "top_kernels_ms": [[k[:100], v] for k, v in top]}


def on_wgmma_forward(names: list) -> bool:
    """Whether a profile's K1 group holds the wgmma forward and nothing
    else."""
    return bool(names) and all("fwd_wgmma_kernel" in n for n in names)


def capture_k7_inputs(engine) -> dict:
    """Arms the engine's optimizer for its next update: just before it
    launches K7, the returned dict receives copies on the card of the flat
    masters, gradients (unscaled and clipped) and moments it takes, with
    its learning rate, update count and skip flag as the device scalars
    K7 reads. The launch itself is the engine's."""
    from deepspeed_tpu_torch.ops.fused_optimizer import device_scalar
    opt, taken = engine.optimizer, {}
    step = opt.step

    def capturing_step(grads, skip=None):
        taken.update(lr=device_scalar(opt.current_lr(), "cuda"),
                     count=device_scalar(opt.count + 1, "cuda"),
                     skip=None if skip is None else skip.reshape(1).clone(),
                     p=opt.params.clone(), g=grads.clone(),
                     **{k: t.clone() for k, t in opt.state.items()})
        del opt.step  # the class's step again
        return step(grads, skip)

    opt.step = capturing_step
    return taken


def k7_vs_plain_at_path_size(engine, taken: dict, chunk: int = 1 << 26) -> dict:
    """What the engine's K7 update (taken by ``capture_k7_inputs``, then
    run) wrote over the whole flat buffer against the plain version on the
    same inputs, ``chunk`` elements at a time: the largest ulp distance of
    each output. LAMB: the plain first pass writes u over the gradient
    copy, then ``lamb_apply_trust_`` (the engine's own) over the copies."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.runtime import optimizers as opts
    opt = engine.optimizer
    n, lr, t, skip = opt.params.numel(), taken["lr"], taken["count"], taken["skip"]
    got = {"p": opt.params, **opt.state}
    ulps = {k: 0 for k in got}

    def hold(name, sl, ref):
        ulps[name] = max(ulps[name], ulp_distance(got[name][sl], ref))

    for a in range(0, n, chunk):
        sl = slice(a, min(a + chunk, n))
        p, g, m = taken["p"][sl], taken["g"][sl], taken["m"][sl]
        if isinstance(opt, opts.Adam):
            ref = fo.adam_update_reference(p, g, m, taken["v"][sl], lr, t, *opt.betas,
                                           opt.eps, opt.weight_decay, l2=opt.l2, skip=skip)
            refs = zip("pmv", ref)
        elif isinstance(opt, opts.Lion):
            refs = zip("pm", fo.lion_update_reference(p, g, m, lr, *opt.betas,
                                                      opt.weight_decay, skip))
        else:
            u, m_n, v_n = fo.lamb_update_reference(g, m, taken["v"][sl], t, *opt.betas,
                                                   opt.eps, skip, g)
            g.copy_(u)
            refs = (("m", m_n), ("v", v_n))
        for name, ref in refs:
            hold(name, sl, ref)
    if isinstance(opt, opts.Lamb):
        fo.lamb_apply_trust_(taken["p"], taken["g"], lr, opt.weight_decay, opt.bounds, skip)
        for a in range(0, n, chunk):
            sl = slice(a, min(a + chunk, n))
            hold("p", sl, taken["p"][sl])
    torch.cuda.synchronize()
    return {"n": n, "update": int(t.item()), "skipped": bool(skip is not None and skip.item()),
            "ulps": ulps, "max_ulps": max(ulps.values())}


def attention_route(cfg, B: int, S: int, dtype) -> dict:
    """The attention route's Decisions for a model's calls at batch B x S
    (``kernel_dispatch.resolve`` for each layer's window and the softcap,
    on this card's kind and the cache the phase sees): the ``describe()``
    notes, and whether both legs of every layer resolve to kernels."""
    from deepspeed_tpu_torch.models.llama import _layer_window
    from deepspeed_tpu_torch.ops import kernel_dispatch as kd
    sigs = {kd.make_sig((B, S, cfg.num_attention_heads, cfg.head_dim_),
                        cfg.num_key_value_heads, S, dtype, True, _layer_window(cfg, i),
                        cfg.attn_logit_softcapping)
            for i in range(cfg.num_hidden_layers)}
    decisions = [kd.resolve(sig) for sig in sigs]
    return {"describe": sorted({kd.describe(*d) for d in decisions}),
            "table": kd.table_source(),
            "impls": sorted({d.impl for pair in decisions for d in pair}),
            "on_kernels": all(d.impl != kd.IMPL_XLA for pair in decisions for d in pair)}


def phase_training() -> dict:
    """initialize() -> forward/backward/step at the Llama-3-8B width, depth
    cut to 4 layers so the fp32 masters, AdamW moments and gradient buffer
    fit one 80 GB card."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops.fused_optimizer import adam_step_, device_scalar

    L, B, S, n_steps = 4, 2, 2048, 6
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=L, ce_chunk_size=8192)
    t0 = time.monotonic()
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": B, "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 1e-4, "warmup_num_steps": 4,
            "warmup_type": "linear"}},
        "gradient_clipping": 1.0})
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()

    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
               adam_step_)
    route = attention_route(cfg, B, S, torch.bfloat16)
    print(f"training attention route: {route['describe']}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    losses, step_s, per_step = [], [], []
    for i in range(n_steps):
        if i == n_steps - 1:
            # the last step's K7 launch is held against the plain version
            # over the whole buffer; its copies stay out of the peak
            peak = torch.cuda.max_memory_allocated() / 2**30
            taken = capture_k7_inputs(engine)
        before = [f.launches for f in kernels]
        torch.cuda.synchronize()
        t = time.monotonic()
        loss = engine.forward(ids, labels=ids)
        engine.backward(loss)
        engine.step()
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        losses.append(loss.item())
        per_step.append([f.launches - b for f, b in zip(kernels, before)])
    launches = {f.__name__: f.launches for f in kernels}
    k7_path = k7_vs_plain_at_path_size(engine, taken)
    del taken
    free_memory()

    def step(events):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        loss = engine.forward(ids, labels=ids)
        mark(1)
        engine.backward(loss)
        mark(2)
        engine.step()
        mark(3)

    profile = profile_step(step)

    # K7 and the library's fused AdamW, each timed on the engine's flat
    # state (the library with moments of its own); this moves the masters,
    # so it comes last
    opt = engine.optimizer
    state = (opt.params, engine._flat_grad, opt.state["m"], opt.state["v"])
    scalars = [device_scalar(x, "cuda") for x in (opt.current_lr(), opt.count + 1)]
    same_state = {"k7_ms": time_ms(lambda: adam_step_(
        *state, *scalars, *opt.betas, opt.eps, opt.weight_decay))}
    lib_p = torch.nn.Parameter(opt.params)
    lib_p.grad = engine._flat_grad
    lib = torch.optim.AdamW([lib_p], lr=opt.current_lr(), betas=opt.betas, eps=opt.eps,
                            weight_decay=opt.weight_decay, fused=True)
    same_state["library_ms"] = time_ms(lib.step)
    same_state["library"] = "torch.optim.AdamW(fused=True).step"
    del lib, lib_p, state

    # model FLOPs of a step: 6 x tokens x matmul weights (the layers'
    # projections and the unembed; the embedding is a gather) plus the
    # attention products, 12*D per visible pair and query head (forward 4,
    # backward 8, without the backward's recompute)
    h, hd, nq, nkv, inter = (cfg.hidden_size, cfg.head_dim_, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.intermediate_size)
    layer_w = h * hd * (2 * nq + 2 * nkv) + 3 * h * inter
    matmul_w = L * layer_w + h * cfg.vocab_size
    tokens = B * S
    attn_flops = 12 * hd * (S * (S + 1) // 2) * nq * B * L
    model_flops = 6 * tokens * matmul_w + attn_flops
    steady = sum(step_s[1:-1]) / (n_steps - 2)  # not the first, nor the checked one
    checks = {
        "losses_finite": all(np.isfinite(losses)),
        "last_loss_below_first": losses[-1] < losses[0],
        "flash_launches_L_per_step": all(c[:3] == [L, L, L] for c in per_step),
        "k7_one_launch_per_applied_step": all(c[3] == 1 for c in per_step)
        and engine.skipped_steps == 0,
        "k7_at_path_size_within_ulps": k7_path["max_ulps"] <= K7_ULPS,
        "attention_route_on_kernels": route["on_kernels"],
        "k1_profile_on_fwd_wgmma_kernel": on_wgmma_forward(profile["k1_kernels"]),
    }
    rec = {"phase": "training", "attention_route": route,
           "config": "llama3_8b(num_hidden_layers=4, "
           "ce_chunk_size=8192), random bf16 weights, fp32 masters, AdamW (K7) lr 1e-4 + "
           "WarmupLR(linear, 4 steps) + clip 1.0, batch 2 x 2048 (one repeated batch)",
           "gpu": gpu_identity(), "params": n_params, "engine_build_s": build_s,
           "losses": losses, "step_s": step_s, "steady_step_ms": steady * 1e3,
           "tokens_per_s": tokens / steady, "peak_memory_gib": peak,
           "model_tflop_per_step": model_flops / 1e12,
           "model_flop_share": model_flops / (steady * BF16_FLOPS),
           "grad_norm_last": engine.get_global_grad_norm(), "lr_last": engine.get_lr()[0],
           "launches": launches, "launches_per_step": per_step,
           "optimizer_step_ms": profile["group_ms"].get("optimizer step"),
           "k7_ms": profile["k7_ms"], "k7_path_check": k7_path,
           "same_state": same_state, "profile": profile, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    del engine, model, ids, loss
    free_memory()
    if not rec["ok"]:
        raise SystemExit(f"training checks failed: {checks}")
    return rec


def fingerprint(t, chunk: int = 1 << 26) -> list:
    """Three int64 sums over the 32-bit (or 16-bit) words of ``t``: of the
    words, of each word times an odd weight of its position in its chunk,
    and of the words' squares (all wrapping). Two buffers that differ in any
    bit give other sums except by a collision of all three; no copy of the
    buffer is kept, so a step can be checked without doubling its state."""
    import torch
    words = t.reshape(-1).view(torch.int32 if t.element_size() == 4 else torch.int16)
    pos = torch.arange(1, 2 * min(chunk, words.numel()), 2, device=t.device)
    acc = torch.zeros(3, dtype=torch.int64, device=t.device)
    for c0 in range(0, words.numel(), chunk):
        w = words[c0:c0 + chunk].long()
        acc += torch.stack([w.sum(), (w * pos[:w.numel()]).sum(), (w * w).sum()])
    return acc.tolist()


# the training_optimizers phase: name, optimizer section, precision, steps
TRAIN_OPTIMIZER_RUNS = (
    ("lion_bf16", {"type": "Lion", "params": {"lr": 1e-5, "weight_decay": 0.01}},
     {"bf16": {"enabled": True}}, 3),
    ("lamb_bf16", {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
     {"bf16": {"enabled": True}}, 3),
    ("adamw_fp16", {"type": "AdamW", "params": {"lr": 1e-4}},
     {"fp16": {"enabled": True}}, 6),
)
# the fp16 run's steps (0-based) whose gradients get an inf, so that skips
# are exercised whatever the natural overflows: the first burns the
# hysteresis (2), the second halves the scale
FP16_INJECTED_STEPS = (2, 4)


def phase_training_optimizers() -> dict:
    """initialize() at phase 5's width (Llama-3-8B cut to 4 layers, batch
    2 x 2048) with Lion (bf16), LAMB (bf16, weight decay 0.01) and AdamW
    under fp16 with dynamic loss scaling (defaults: 2^16, hysteresis 2):
    losses, step and optimizer-step ms, one K7 launch per step. In
    the fp16 run, steps 3 and 5 get an inf in one gradient element; around
    every skipped step the flat masters, moments and compute copy keep
    their fingerprints, and the scale trajectory is ``update_scale``
    replayed on the observed overflow flags. The last step of each run
    holds its K7 launch against the plain version over the whole flat
    buffer (``capture_k7_inputs``): that step's times include the copies
    and its memory stays out of the peak. Step times leave out the
    fingerprints. Each engine is freed before the next."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.runtime import loss_scaler

    L, B, S = 4, 2, 2048
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=L, ce_chunk_size=8192)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    wrappers = {"adamw": fo.adam_step_, "lion": fo.lion_step_, "lamb": fo.lamb_update_}
    flash = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv)
    runs, checks = {}, {}
    for name, optimizer, precision, n_steps in TRAIN_OPTIMIZER_RUNS:
        model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
            "train_batch_size": B, "optimizer": optimizer, "gradient_clipping": 1.0,
            **precision})
        fp16 = "fp16" in precision
        k7 = wrappers[name.split("_")[0]]
        route = attention_route(cfg, B, S, torch.float16 if fp16 else torch.bfloat16)
        print(f"training_optimizers {name} attention route: {route['describe']}",
              flush=True)
        checks[f"{name}_attention_route_on_kernels"] = route["on_kernels"]
        torch.cuda.reset_peak_memory_stats()
        for f in (k7, *flash):
            f.launches = 0
        losses, step_ms, opt_ms, overflows, scales, kept = [], [], [], [], [], []
        for i in range(n_steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t = time.monotonic()
            loss = engine.forward(ids, labels=ids)
            engine.backward(loss)
            torch.cuda.synchronize()
            fwd_bwd_s = time.monotonic() - t
            if fp16 and i in FP16_INJECTED_STEPS:
                engine._grad_acc[0].view(-1)[0] = float("inf")
            if fp16:
                state = {"masters": engine.optimizer.params, "compute": engine._flat_compute,
                         **engine.optimizer.state}
                before = {k: fingerprint(v) for k, v in state.items()}
            if i == n_steps - 1:
                peak = torch.cuda.max_memory_allocated() / 2**30
                taken = capture_k7_inputs(engine)
            skipped = engine.skipped_steps
            torch.cuda.synchronize()
            t = time.monotonic()
            ev[0].record()
            engine.step()
            ev[1].record()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (fwd_bwd_s + time.monotonic() - t))
            opt_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(loss.item())
            overflows.append(engine.skipped_steps > skipped)
            scales.append(engine.cur_scale)
            if fp16 and overflows[-1]:
                kept.append(all(fingerprint(v) == before[k] for k, v in state.items()))
        # the last step's K7 launch over the whole buffer, against the plain
        # version (with its skip flag)
        k7_path = k7_vs_plain_at_path_size(engine, taken)
        del taken
        applied = n_steps - engine.skipped_steps
        run = {"config": {"optimizer": optimizer, **precision}, "steps": n_steps,
               "losses": losses, "step_ms": step_ms, "optimizer_step_ms": opt_ms,
               "attention_route": route,
               "k7": k7.__name__, "k7_launches": k7.launches, "applied_steps": applied,
               "peak_memory_gib": peak, "k7_path_check": k7_path}
        checks[f"{name}_losses_finite"] = bool(np.isfinite(losses).all())
        # every step launches K7, which reads the overflow flag on the card
        # and writes nothing on a skipped step
        checks[f"{name}_k7_one_launch_per_step"] = k7.launches == n_steps and applied > 0
        checks[f"{name}_k7_at_path_size_within_ulps"] = (
            k7_path is not None and k7_path["max_ulps"] <= K7_ULPS)
        if fp16:
            fp16_cfg = engine._config.fp16_config
            replay, st = [], loss_scaler.initial_state(fp16_cfg)
            for ov in overflows:
                st = loss_scaler.next_state(fp16_cfg, st, ov)
                replay.append(st.cur_scale)
            run.update({"overflows": overflows, "cur_scale": scales,
                        "replayed_scale": replay, "injected_steps": FP16_INJECTED_STEPS,
                        "skipped_steps": engine.skipped_steps,
                        "skipped_state_kept": kept,
                        "flash_fp16_launches": {f.__name__: f.launches for f in flash}})
            checks.update({
                "fp16_injected_steps_skipped": all(overflows[i] for i in FP16_INJECTED_STEPS),
                "fp16_skipped_steps_keep_state": len(kept) == sum(overflows) and all(kept),
                "fp16_scale_follows_update_scale": scales == replay,
                "fp16_skipped_and_scale_agree": engine.skipped_steps == sum(overflows)
                and engine.cur_scale == replay[-1],
                "fp16_flash_launches_L_per_step": all(
                    f.launches == L * n_steps for f in flash),
            })
            # after the counts: one more forward, traced, for K1's kernel
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.forward(ids, labels=ids)
                torch.cuda.synchronize()
            run["k1_kernels"] = sorted({e.name for e in prof.events()
                                        if _kernel_group(e.name) == "K1 flash fwd"})
            checks["fp16_k1_profile_on_fwd_wgmma_kernel"] = on_wgmma_forward(
                run["k1_kernels"]) and all("__half" in n for n in run["k1_kernels"])
        runs[name] = run
        del engine, model, loss
        free_memory()
    rec = {"phase": "training_optimizers", "config": "llama3_8b(num_hidden_layers=4, "
           "ce_chunk_size=8192), random bf16 weights, batch 2 x 2048 (one repeated batch), "
           "clip 1.0", "gpu": gpu_identity(), "runs": runs, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"training_optimizers checks failed: {checks}")
    return rec


# the Mistral phase's steps per run. Both runs apply the same per-head
# body, in the same order and without atomics, to every (query tile, KV
# head) (K3 walks a tile's KV heads in one block), so the two runs' losses
# must be equal bit for bit at every step
MISTRAL_STEPS = 6


def phase_training_mistral() -> dict:
    """initialize() at the published mistralai/Mistral-7B-v0.1 widths
    (``policy_for("mistral").config_from_hf(MISTRAL_7B)``: hidden 4096,
    intermediate 14336, 32 / 8 heads, vocab 32000, rope theta 10000,
    sliding window 4096, untied embeddings), depth cut to 4 layers as in
    phase 5 (1.134e9 parameters, ~18 GB of fp32 state), seeded random bf16
    weights, one 8192-token sequence (one repeated batch), AdamW (K7) lr
    1e-4 + WarmupLR(linear, 4 steps) + clip 1.0, 6 steps, twice from the
    same initial weights and batch: run ``resolved`` with the route as it
    resolves on an empty cache (K1/K2 on both legs), run ``folded`` with
    both legs pinned by ``DS_TPU_ATTN_FWD``/``DS_TPU_ATTN_BWD=folded``
    (K3). Checks each run's decisions, 4 x 6 launches of each of its three
    attention kernels and none of the other layout's, one K7 launch per
    step, finite falling losses, and the two runs' losses equal bit for
    bit at every step. Reports per run the step time on the
    host clock (mean of steps 2-6) and on CUDA events, tokens/s, the
    model-FLOP share (the window's visible pairs), the peak memory, and
    after the counts are read a profiled step by kernel group."""
    import dataclasses

    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import init_llama_for_causal_lm
    from deepspeed_tpu_torch.module_inject import MISTRAL_7B, policy_for
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops import attention_folded as ff
    from deepspeed_tpu_torch.ops.fused_optimizer import adam_step_

    L, B, S, n_steps = 4, 1, MISTRAL_S, MISTRAL_STEPS
    cfg = dataclasses.replace(policy_for("mistral").config_from_hf(MISTRAL_7B),
                              num_hidden_layers=L, ce_chunk_size=8192)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    layouts = {"per_head": (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                            fa.flash_attention_bwd_dkdv),
               "folded": (ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
                          ff.folded_attention_bwd_dkdv)}
    counted = layouts["per_head"] + layouts["folded"] + (adam_step_, )
    # model FLOPs of a step, as phase 5's, the attention over the window's
    # visible pairs
    h, hd, nq, nkv, inter = (cfg.hidden_size, cfg.head_dim_, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.intermediate_size)
    matmul_w = L * (h * hd * (2 * nq + 2 * nkv) + 3 * h * inter) + h * cfg.vocab_size
    pairs = visible_pairs(S, True, cfg.sliding_window)
    model_flops = 6 * B * S * matmul_w + 12 * hd * pairs * nq * B * L
    runs, checks = {}, {}
    for name, pin, layout in (("resolved", None, "per_head"),
                              ("folded", "folded", "folded")):
        for var in ("DS_TPU_ATTN_FWD", "DS_TPU_ATTN_BWD"):
            if pin:
                os.environ[var] = pin
            else:
                os.environ.pop(var, None)
        route = attention_route(cfg, B, S, torch.bfloat16)
        print(f"training_mistral {name} attention route: {route['describe']}", flush=True)
        model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
            "train_batch_size": B, "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": 1e-4, "warmup_num_steps": 4,
                "warmup_type": "linear"}},
            "gradient_clipping": 1.0})
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in counted:
            f.launches = 0
        losses, step_s, step_ev_ms = [], [], []
        for _ in range(n_steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t = time.monotonic()
            ev[0].record()
            loss = engine.forward(ids, labels=ids)
            engine.backward(loss)
            engine.step()
            ev[1].record()
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t)
            step_ev_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(loss.item())
        launches = {f.__name__: f.launches for f in counted}
        peak = torch.cuda.max_memory_allocated() / 2**30

        def step(events):
            mark = (lambda i: events[i].record()) if events else (lambda i: None)
            mark(0)
            out = engine.forward(ids, labels=ids)
            mark(1)
            engine.backward(out)
            mark(2)
            engine.step()
            mark(3)

        profile = profile_step(step)
        steady = sum(step_s[1:]) / (n_steps - 1)
        other = "folded" if layout == "per_head" else "per_head"
        checks.update({
            f"{name}_route": route["impls"] == [pin or "pallas"],
            f"{name}_{layout}_launches_L_per_step": all(
                launches[f.__name__] == L * n_steps for f in layouts[layout]),
            f"{name}_no_{other}_launches": all(
                launches[f.__name__] == 0 for f in layouts[other]),
            f"{name}_k7_one_launch_per_step": launches["adam_step_"] == n_steps,
            f"{name}_losses_finite": bool(np.isfinite(losses).all()),
            f"{name}_last_loss_below_first": losses[-1] < losses[0],
            f"{name}_k1_profile_on_fwd_wgmma_kernel": on_wgmma_forward(profile["k1_kernels"]),
        })
        runs[name] = {"pin": pin, "attention_route": route, "params": n_params,
                      "losses": losses, "step_s": step_s, "step_event_ms": step_ev_ms,
                      "steady_step_ms": steady * 1e3,
                      "steady_step_event_ms": sum(step_ev_ms[1:]) / (n_steps - 1),
                      "tokens_per_s": B * S / steady,
                      "model_flop_share": model_flops / (steady * BF16_FLOPS),
                      "peak_memory_gib": peak, "launches": launches, "profile": profile}
        del engine, model, loss
        free_memory()
    for var in ("DS_TPU_ATTN_FWD", "DS_TPU_ATTN_BWD"):
        os.environ.pop(var, None)
    a, b = runs["resolved"]["losses"], runs["folded"]["losses"]
    checks["losses_bit_equal"] = a == b
    rec = {"phase": "training_mistral",
           "config": "policy_for('mistral').config_from_hf(MISTRAL_7B) with "
                     "num_hidden_layers=4 (cut from 32), ce_chunk_size=8192; random bf16 "
                     "weights (seed 0), fp32 masters, AdamW (K7) lr 1e-4 + WarmupLR(linear, "
                     "4 steps) + clip 1.0, batch 1 x 8192 (one repeated batch)",
           "reduced": {"num_hidden_layers": [32, 4]},
           "gpu": gpu_identity(), "visible_pairs_per_head": pairs,
           "model_tflop_per_step": model_flops / 1e12, "runs": runs,
           "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"training_mistral checks failed: {checks}")
    return rec


# Gemma-2-9B serving: 8 prompts of 128..5120 tokens, four past the 4096
# window of the even layers, 32 new tokens each: 21,376 tokens in 338 of
# the 390 KV blocks of 64 that the 8 GiB budget holds at 344,064 bytes per
# token (42 layers)
GEMMA2_PROMPTS = [5120, 4864, 4352, 3072, 2048, 1024, 512, 128]
GEMMA2_NEW_TOKENS = 32
# the random weights: the norm deltas w ~ N(0, 0.1) (HF's test of the model
# draws them so), q_proj and k_proj 4.5x lecun-normal (scaled scores ~ N(0,
# 20^2): the attention cap of 50 bites on ~22% of them), and the embedding
# 20x normal(0.02) (final logits ~ N(0, 24^2): the final cap of 30 bites on
# ~half of them). The sharp attention the cap bites makes 42 layers
# chaotic: with the embedding as drawn, one bf16 rounding of the embedded
# input moves the plain fp32 forward to a cosine of 0.41, and fp32's own
# roundings move the fp32 engine to 0.9996 (on the H100). The wide
# embedding leads the residual stream and holds that rounding to 0.999996.
GEMMA2_QK_SCALE, GEMMA2_EMBED_SCALE = 4.5, 20.0
# the bf16 engine against the plain fp32 forward on the 5120-token prompt,
# its prefill and the decode step of its last token, and the two against
# each other (the final cap bounds max|logit|, so the limit is a cosine),
# as StarCoder2's and BLOOM's limit; every run reads five controls (no
# attention cap, no final cap, no post norms, no embedding scale, a window
# on every layer) and fails if any is within the limit
GEMMA2_COSINE = 0.999
# the fp32 engine at the weights as first drawn (the norm deltas alone:
# no chaos, one bf16 rounding of the input moves the forward by ~1e-5 of
# cosine) against the same forward of those weights
GEMMA2_FP32_COSINE = 0.9999
GEMMA2_FP32_BLOCKS = 96  # the 5120-token prompt and its decode step


def gemma2_random_model(cfg, dtype, qk_scale: float = 1.0, embed_scale: float = 1.0):
    """Gemma-2-form seeded random weights on the card: ``init_llama``'s
    draw, the norm deltas ~ N(0, 0.1), q_proj and k_proj ``qk_scale``
    times wider and the embedding ``embed_scale`` times."""
    import torch
    from deepspeed_tpu_torch.models.llama import RMSNormWeight, init_llama
    model = init_llama(cfg, seed=0, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, RMSNormWeight):
                mod.weight.copy_(0.1 * torch.randn(mod.weight.shape, generator=gen,
                                                   device="cuda"))
        for layer in model.layers:
            layer.self_attn.q_proj.kernel.mul_(qk_scale)
            layer.self_attn.k_proj.kernel.mul_(qk_scale)
        model.embed_tokens.weight.mul_(embed_scale)
    return model


def prefill_and_decode(engine, uid: int, tokens: list):
    """``tokens`` fed in chunks of the batch budget, the last chunk's
    logits (prefill); then fed again without the last token, and that
    token's decode step's logits. Both sequences are flushed."""
    budget = engine._config.state_manager.max_ragged_batch_size

    def feed(u, toks):
        for ofs in range(0, len(toks), budget):
            logits = engine.put([u], [toks[ofs:ofs + budget]])
        return logits

    full = feed(uid, tokens).float()[0]
    engine.flush(uid)
    feed(uid + 1, tokens[:-1])
    step = engine.put([uid + 1], [[tokens[-1]]]).float()[0]
    engine.flush(uid + 1)
    return full, step


def plain_forward_gemma2_fp32(model, cfg, tokens: list, q_block: int = 1024,
                              attn_cap: bool = True, final_cap: bool = True,
                              post_norms: bool = True, embed_scale: bool = True,
                              window_everywhere: bool = False, round_input: bool = False):
    """The last token's logits of ``tokens`` from a plain fp32 forward of a
    Gemma-2-form ``model`` (the (1 + w) RMSNorm, sandwich norms, rope, G
    query heads per KV head, the attention scale, cap and window of the
    config's layers, the tanh-gelu gate, tied embeddings times the
    embedding scale, the final cap): every weight cast to fp32 where it is
    used, no KV cache and no kernel of the port; each block of ``q_block``
    queries attends over the whole sequence under a dense mask. The
    controls leave out the attention cap, the final cap, the post norms
    (``post_attention_layernorm`` and ``post_feedforward_layernorm``) or
    the embedding scale, or put the window on every layer;
    ``round_input`` rounds the scaled embedded input once to bf16. Also returns
    the share of visible scaled scores past the attention cap / 2 and of
    the logits past the final cap / 2."""
    import torch
    import torch.nn.functional as F
    dev = model.embed_tokens.weight.device
    T = len(tokens)
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    pos = torch.arange(T, device=dev)
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, device=dev,
                                                      dtype=torch.float32) / hd))
    ang = pos.float()[:, None] * inv_freq[None, :]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]

    def norm(x, mod):
        scale = 1.0 + mod.weight.float()
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.rms_norm_eps) * scale

    def lin(x, dense):
        return x @ dense.kernel.float()

    def rope(x):
        x1, x2 = x.chunk(2, -1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    emb = model.embed_tokens.weight
    x = emb[torch.tensor(tokens, device=dev)].float()
    if embed_scale:
        x = x * cfg.embed_scale
    if round_input:
        x = x.bfloat16().float()
    cap, bites, seen = cfg.attn_logit_softcapping, 0, 0
    for l, layer in enumerate(model.layers):
        a = layer.self_attn
        W = cfg.sliding_window if (window_everywhere or l in cfg.sliding_window_layers) else T
        h = norm(x, layer.input_layernorm)
        q = rope(lin(h, a.q_proj).view(T, nq, hd))
        k = rope(lin(h, a.k_proj).view(T, nkv, hd)).repeat_interleave(nq // nkv, 1)
        v = lin(h, a.v_proj).view(T, nkv, hd).repeat_interleave(nq // nkv, 1)
        ctx = torch.empty(T, nq, hd, device=dev)
        for q0 in range(0, T, q_block):
            qp = pos[q0:q0 + q_block, None]
            scores = torch.einsum("qhd,khd->hqk", q[q0:q0 + q_block], k) * cfg.attn_scale
            keep = (pos[None, :] <= qp) & (pos[None, :] > qp - W)
            bites += int(((scores.abs() > cap / 2) & keep).sum())
            seen += int(keep.sum()) * nq
            if attn_cap:
                scores = cap * torch.tanh(scores / cap)
            probs = scores.masked_fill(~keep, float("-inf")).softmax(-1)
            ctx[q0:q0 + q_block] = torch.einsum("hqk,khd->qhd", probs, v)
        attn = lin(ctx.reshape(T, nq * hd), a.o_proj)
        x = x + (norm(attn, layer.post_attention_layernorm) if post_norms else attn)
        m, h2 = layer.mlp, norm(x, layer.pre_feedforward_layernorm)
        mlp = lin(F.gelu(lin(h2, m.gate_proj), approximate="tanh") * lin(h2, m.up_proj),
                  m.down_proj)
        x = x + (norm(mlp, layer.post_feedforward_layernorm) if post_norms else mlp)
    x = norm(x[-1:], model.norm)
    logits = (x @ emb.float().T)[0]
    fcap = cfg.final_logit_softcapping
    shares = {"attn_cap_bite_share": bites / seen,
              "final_cap_bite_share": float((logits.abs() > fcap / 2).float().mean())}
    if final_cap:
        logits = fcap * torch.tanh(logits / fcap)
    return logits, shares


def phase_serving_gemma2(kernels: list) -> dict:
    """Gemma-2-9B through the user's entry points at full width and depth:
    the published config through ``policy_for("gemma2")
    .config_from_hf(GEMMA2_9B)`` (42 layers, hidden 3584, 16 / 8 heads of
    256, window 4096 on the even layers, caps 50 and 30, vocab 256000,
    tied), seeded random bf16 weights (``gemma2_random_model``, q/k
    GEMMA2_QK_SCALE and the embedding GEMMA2_EMBED_SCALE times),
    ``build_llama_engine``,
    ``generate``. K4's softcap instance L times and K5's fp32-scale
    instance 4L+1 times per forward; no KV block freed while the odd
    layers attend globally; the 5120-token prompt's prefill logits and its
    last token's decode step against a plain fp32 forward and five
    controls. Then the fp32 engine at the weights as first drawn (the
    norm deltas alone) on the same prompt against the plain fp32 forward
    of those weights."""
    import torch
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.module_inject import GEMMA2_9B, policy_for
    from deepspeed_tpu_torch.ops.normalization import layer_norm, rms_norm
    from deepspeed_tpu_torch.ops.paged_attention import KERNEL_COUNTERS, paged_attention

    cfg = policy_for("gemma2").config_from_hf(GEMMA2_9B)
    blocks = {"freed": [], "max_live": {}}

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(a, b, dim=0).item()

    def on_put(engine, uids):
        """Every allocated block stays live: the odd layers attend to the
        whole history."""
        for u in uids:
            seq = engine._state_manager.get_sequence(u)
            if seq is None:
                continue
            live = len(seq.kv_blocks)
            if live != seq.cur_allocated_blocks:
                blocks["freed"].append([u, seq.seen_tokens, live, seq.cur_allocated_blocks])
            blocks["max_live"][u] = max(blocks["max_live"].get(u, 0), live)

    refs = {}

    def inspect(engine, prompts, prefill_logits):
        model = engine.model().model
        got = prefill_logits[0].cuda()
        t = time.monotonic()
        with torch.no_grad():
            ref, shares = plain_forward_gemma2_fp32(model, cfg, prompts[0])
        torch.cuda.synchronize()
        forward_s = time.monotonic() - t
        controls = {}
        for name, kw in (("no_attn_cap", {"attn_cap": False}),
                         ("no_final_cap", {"final_cap": False}),
                         ("no_post_norms", {"post_norms": False}),
                         ("no_embed_scale", {"embed_scale": False}),
                         ("window_every_layer", {"window_everywhere": True})):
            with torch.no_grad():
                ctl, _ = plain_forward_gemma2_fp32(model, cfg, prompts[0], **kw)
            controls[name] = {"cosine_vs_plain_fp32": cosine(ctl, ref),
                              "cosine_vs_engine": cosine(ctl, got)}
        with torch.no_grad():
            rounded, _ = plain_forward_gemma2_fp32(model, cfg, prompts[0], round_input=True)
        refs["plain_fp32"] = ref.cpu()
        cos = cosine(got, ref)
        n_params = sum(p.numel() for p in model.parameters())
        rec = {"plain_fp32_forward_s": forward_s, "parameters": n_params,
               "prefill_logits_cosine_vs_plain_fp32": cos,
               "plain_fp32_prompt_tokens": len(prompts[0]),
               "prefill_vs_plain_max_abs_diff": (got - ref).abs().max().item(),
               "plain_fp32_input_rounded_to_bf16_cosine": cosine(rounded, ref),
               **shares, "cosine_controls": controls}
        return rec, {"prefill_logits_cosine_vs_plain_fp32": cos >= GEMMA2_COSINE,
                     "cosine_controls_outside_the_limit": all(
                         c["cosine_vs_plain_fp32"] < GEMMA2_COSINE
                         for c in controls.values()),
                     "both_caps_bite": min(shares.values()) >= CAP_BITES,
                     "parameters_9241705984": n_params == 9_241_705_984}

    counters = {"paged_attention_softcap": (paged_attention, "softcap_launches"),
                "rms_norm_fp32_scale": (rms_norm, "fp32_scale_launches"),
                "paged_attention": (paged_attention, "launches"),
                "paged_attention_int8": (paged_attention, "int8_launches"),
                "paged_attention_alibi": (paged_attention, "alibi_launches"),
                "rms_norm": (rms_norm, "launches"), "layer_norm": (layer_norm, "launches")}
    run = _drive_serving(
        counters, cfg=cfg, prompt_lens=GEMMA2_PROMPTS, new_tokens=GEMMA2_NEW_TOKENS,
        make_params=lambda: gemma2_random_model(cfg, torch.bfloat16, GEMMA2_QK_SCALE,
                                                GEMMA2_EMBED_SCALE),
        check_prompt=0, on_put=on_put, inspect=inspect,
        norms_per_forward={"rms_norm_fp32_scale": 4 * cfg.num_hidden_layers + 1})
    rec, checks, L = run["rec"], run["checks"], run["layers"]
    n_fwd, launches = rec["forwards"], rec["launches"]
    max_live = blocks["max_live"]
    # prefill against decode on the 5120-token prompt, and its decode step
    # against the plain fp32 forward
    full, step = run["check_logits"]
    decode_cos, pd_cos = cosine(step, refs["plain_fp32"]), cosine(full, step)
    rec.update({"decode_logits_cosine_vs_plain_fp32": decode_cos,
                "prefill_decode_cosine": pd_cos})
    checks.update({
        "decode_logits_cosine_vs_plain_fp32": decode_cos >= GEMMA2_COSINE,
        "prefill_decode_consistent": pd_cos >= GEMMA2_COSINE,
        "paged_attention_softcap_launches_per_forward":
            launches["paged_attention_softcap"] == L * n_fwd,
        "rms_norm_fp32_scale_launches_per_forward":
            launches["rms_norm_fp32_scale"] == (4 * L + 1) * n_fwd,
        "no_other_k4_or_norm_instance": all(
            launches[k] == 0 for k in ("paged_attention", "paged_attention_int8",
                                       "paged_attention_alibi", "rms_norm", "layer_norm")),
        "no_block_freed_while_odd_layers_are_global": not blocks["freed"],
        "longest_prompt_holds_all_its_blocks": max_live[0] == (5120 + 32 + 63) // 64,
    })

    # the fp32 engine at the weights as first drawn, on the same prompt: K4's
    # fp32 chunk kernel once per layer in every prefill chunk (768 tokens,
    # the budget, and the prompt's last 512 or 511: 14 forwards), its fp32
    # decode kernel once per layer in the decode step, no other K4 kernel
    prompt = run["prompts"][0]
    model = gemma2_random_model(cfg, torch.float32)
    engine = build_llama_engine(
        cfg, params=model, dtype=torch.float32, kv_block_size=64,
        engine_config=RaggedInferenceEngineConfig(num_kv_blocks=GEMMA2_FP32_BLOCKS))
    inner32, forwards32 = engine.model().forward, []
    pa = paged_attention

    def counts32():
        return [getattr(pa, c) for c in KERNEL_COUNTERS]

    def counted32(batch, **kw):
        before = counts32()
        out = inner32(batch, **kw)
        forwards32.append((batch.n_tokens, batch.q_tok_idx.shape[1] == 1,
                           [a - b for a, b in zip(counts32(), before)]))
        return out
    engine.model().forward = counted32
    full32, step32 = prefill_and_decode(engine, 2000, prompt)
    engine.model().forward = inner32
    by_kind = {kind: sum(k[i] for _, _, k in forwards32) for i, kind in enumerate(K4_KINDS)}
    chunk_fwds = [k for _, dec, k in forwards32 if not dec]
    decode_fwds = [k for _, dec, k in forwards32 if dec]
    k4_fp32 = {**by_kind, "forwards": len(forwards32), "chunk_forwards": len(chunk_fwds),
               "decode_forwards": len(decode_fwds),
               "tokens_per_forward": [n for n, _, _ in forwards32]}
    with torch.no_grad():
        ref32, shares32 = plain_forward_gemma2_fp32(model, cfg, prompt)
        rounded32, _ = plain_forward_gemma2_fp32(model, cfg, prompt, round_input=True)
    fp32 = {"weights": "norm deltas N(0, 0.1), the rest as init_llama draws it",
            "k4_launches": k4_fp32, "cosine_tolerance": GEMMA2_FP32_COSINE,
            "prefill_cosine_vs_plain_fp32": cosine(full32, ref32),
            "decode_cosine_vs_plain_fp32": cosine(step32, ref32),
            "prefill_decode_max_abs_diff": (full32 - step32).abs().max().item(),
            "plain_fp32_input_rounded_to_bf16_cosine": cosine(rounded32, ref32), **shares32}
    del engine, model, full32, step32, ref32, rounded32
    free_memory()
    checks["fp32_engine_prefill_and_decode_vs_plain_fp32"] = min(
        fp32["prefill_cosine_vs_plain_fp32"],
        fp32["decode_cosine_vs_plain_fp32"]) >= GEMMA2_FP32_COSINE
    chunk_i, decode_i = K4_KINDS.index("f32_chunk"), K4_KINDS.index("f32_decode")
    checks["fp32_engine_f32_chunk_L_per_chunk_and_f32_decode_L_per_decode_forward"] = \
        len(chunk_fwds) > 0 and len(decode_fwds) > 0 and \
        all(k[chunk_i] == L and sum(k) == L for k in chunk_fwds) and \
        all(k[decode_i] == L and sum(k) == L for k in decode_fwds)

    rec = {"phase": "serving_gemma2",
           "config": "GEMMA2_9B via policy_for('gemma2').config_from_hf (42 layers, hidden "
                     "3584, 16/8 heads of 256, window 4096 on the even layers, caps 50/30, "
                     "vocab 256000, tied embeddings; random bf16 weights)",
           "weights": f"norm deltas N(0, 0.1), q/k x{GEMMA2_QK_SCALE}, embedding "
                      f"x{GEMMA2_EMBED_SCALE}",
           **rec, "max_live_blocks": [max_live[u] for u in sorted(max_live) if u < 8],
           "freed_blocks_seen": blocks["freed"][:8],
           "cosine_tolerance": GEMMA2_COSINE, "fp32_engine": fp32,
           "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"Gemma-2 serving checks failed: {checks}")
    for k in kernels:
        if k["name"] in ("paged_attention_softcap", "rms_norm_fp32_scale"):
            k["launches"] = launches[k["name"]]
            k["launches_by_phase"] = {"serving_gemma2": launches[k["name"]]}
        for kind in ("cuda_cores", "f32_chunk", "f32_decode"):
            if k["name"] == "paged_attention_" + kind:
                k["launches"] = k4_fp32[kind]
                k["launches_by_phase"] = {"serving_gemma2/fp32_engine": k4_fp32[kind]}
    count_k4_kernels(kernels, "serving_gemma2", rec)
    return rec


GEMMA2_STEPS = 6


def phase_training_gemma2() -> dict:
    """initialize() at the published google/gemma-2-9b widths
    (``policy_for("gemma2").config_from_hf(GEMMA2_9B)``), depth cut to 4
    layers (two windowed, two global; 1,710,288,384 parameters), seeded
    random bf16 weights, one 8192-token sequence (one repeated batch),
    AdamW (K7) lr 1e-4 + WarmupLR(linear, 4 steps) + clip 1.0, the chunked
    CE with the final softcap, 6 steps, the route as it resolves on an
    empty cache. Checks K1/K2 at head width 256 with the softcap 4 times
    per step each (K3 none), one K7 launch per step, finite falling losses.
    Reports the step time on the host clock (mean of steps 2-6) and on
    CUDA events, tokens/s, the model-FLOP share (the window's visible pairs
    on the even layers), the peak memory, and after the counts are read a
    profiled step by kernel group."""
    import dataclasses

    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import _layer_window, init_llama_for_causal_lm
    from deepspeed_tpu_torch.module_inject import GEMMA2_9B, policy_for
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops import attention_folded as ff
    from deepspeed_tpu_torch.ops.fused_optimizer import adam_step_

    L, B, S, n_steps = 4, 1, MISTRAL_S, GEMMA2_STEPS
    cfg = dataclasses.replace(policy_for("gemma2").config_from_hf(GEMMA2_9B),
                              num_hidden_layers=L, ce_chunk_size=8192)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    per_head = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    folded = (ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
              ff.folded_attention_bwd_dkdv)
    counted = per_head + folded + (adam_step_, )
    h, hd, nq, nkv, inter = (cfg.hidden_size, cfg.head_dim_, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.intermediate_size)
    matmul_w = L * (h * hd * (2 * nq + 2 * nkv) + 3 * h * inter) + h * cfg.vocab_size
    pairs = [visible_pairs(S, True, _layer_window(cfg, i)) for i in range(L)]
    model_flops = 6 * B * S * matmul_w + 12 * hd * sum(pairs) * nq * B
    for var in ("DS_TPU_ATTN_FWD", "DS_TPU_ATTN_BWD"):
        os.environ.pop(var, None)
    route = attention_route(cfg, B, S, torch.bfloat16)
    print(f"training_gemma2 attention route: {route['describe']}", flush=True)
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": B, "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 1e-4, "warmup_num_steps": 4,
            "warmup_type": "linear"}},
        "gradient_clipping": 1.0})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counted:
        f.launches = 0
    losses, step_s, step_ev_ms = [], [], []
    for _ in range(n_steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t = time.monotonic()
        ev[0].record()
        loss = engine.forward(ids, labels=ids)
        engine.backward(loss)
        engine.step()
        ev[1].record()
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        step_ev_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(loss.item())
    launches = {f.__name__: f.launches for f in counted}
    peak = torch.cuda.max_memory_allocated() / 2**30

    def step(events):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        out = engine.forward(ids, labels=ids)
        mark(1)
        engine.backward(out)
        mark(2)
        engine.step()
        mark(3)

    profile = profile_step(step)
    steady = sum(step_s[1:]) / (n_steps - 1)
    checks = {
        "route_on_k1_k2": route["impls"] == ["pallas"],
        "k1_k2_d256_launches_L_per_step": all(
            launches[f.__name__] == L * n_steps for f in per_head),
        "no_k3_launches": all(launches[f.__name__] == 0 for f in folded),
        "k7_one_launch_per_step": launches["adam_step_"] == n_steps,
        "parameters_1710288384": n_params == 1_710_288_384,
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "k1_profile_on_fwd_wgmma_kernel": on_wgmma_forward(profile["k1_kernels"]),
    }
    rec = {"phase": "training_gemma2",
           "config": "policy_for('gemma2').config_from_hf(GEMMA2_9B) with "
                     "num_hidden_layers=4 (cut from 42; windows on layers 0 and 2), "
                     "ce_chunk_size=8192; random bf16 weights (seed 0), fp32 masters, "
                     "AdamW (K7) lr 1e-4 + WarmupLR(linear, 4 steps) + clip 1.0, batch "
                     "1 x 8192 (one repeated batch)",
           "reduced": {"num_hidden_layers": [42, 4]},
           "gpu": gpu_identity(), "attention_route": route, "params": n_params,
           "visible_pairs_per_head_by_layer": pairs,
           "model_tflop_per_step": model_flops / 1e12, "losses": losses,
           "step_s": step_s, "step_event_ms": step_ev_ms, "steady_step_ms": steady * 1e3,
           "steady_step_event_ms": sum(step_ev_ms[1:]) / (n_steps - 1),
           "tokens_per_s": B * S / steady,
           "model_flop_share": model_flops / (steady * BF16_FLOPS),
           "peak_memory_gib": peak, "launches": launches, "profile": profile,
           "checks": checks, "ok": all(checks.values())}
    emit(rec)
    del engine, model, loss
    free_memory()
    if not rec["ok"]:
        raise SystemExit(f"training_gemma2 checks failed: {checks}")
    return rec


# the training_fused phase: Llama-3-8B's width cut to 2 layers (two engines
# of ~27 GB each never live at once), bf16, AdamW + WarmupLR + clip 1.0,
# the chunked CE; windows of FUSED_K steps of 1 x FUSED_SEQ tokens; the
# remat runs at 1 x REMAT_SEQ
FUSED_LAYERS, FUSED_K, FUSED_SEQ, REMAT_SEQ = 2, 4, 4096, 8192
FUSED_CONFIG = {
    "train_batch_size": 1, "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-4, "warmup_num_steps": 4,
        "warmup_type": "linear"}},
    "gradient_clipping": 1.0}
# fp16 from a scale of 2^24, halved at each overflow (hysteresis 1): the
# first steps overflow, the later ones apply
FUSED_FP16 = {"bf16": {"enabled": False},
              "fp16": {"enabled": True, "initial_scale_power": 24, "hysteresis": 1}}
REMAT_RUNS = (("off", {}), ("nothing_saveable", {"remat": True,
                                                  "remat_policy": "nothing_saveable"}),
              ("dots_saveable", {"remat": True, "remat_policy": "dots_saveable"}))


def busy_share(fn) -> dict:
    """One call of ``fn`` traced by ``torch.profiler`` (device activity
    only): its wall ms on the host's clock, the device kernels' summed ms
    and their share of the wall (the device's busy share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t)
    device_ms = sum(e.device_time for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms}


def phase_training_fused() -> dict:
    """The rest of the training engine on one device at the Llama-3-8B
    width (``FUSED_LAYERS`` layers, seeded random bf16 weights):
    (a) ``fused_train_steps`` over two windows of K stacked batches, the
    first under ``torch.cuda.set_sync_debug_mode("error")`` with the one
    fetch outside it, against 2K forward/backward/step from the same
    weights: losses, masters and LR bit for bit; ms per step of a window
    and of the sequential path, and each one's device busy share;
    (b) the same in fp16 with a loss scale that overflows the first steps:
    skipped steps, the scale, the LR and the masters equal; (c) gas-2
    ``train_batch`` against its micro loop, bit for bit; (d) with
    ``grad_accum_dtype`` bf16 the buffer's bytes (half) and the losses
    within 5e-3 relative of fp32 accumulation; (e) remat off,
    ``nothing_saveable`` and ``dots_saveable`` at 1 x ``REMAT_SEQ``: step ms,
    peak memory, K1/K2 launches per step (remat launches K1 again in the
    recompute: the flash output is no product), losses and the flat
    gradient bit-equal across the three; (f) K7 in its device-scalar form
    over the whole flat buffer against the plain version (``K7_ULPS``), and
    a set skip flag leaving masters and moments bit-unchanged. The K1/K2 and
    K7 counts are set to 0 before each run and read after it."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.runtime import loss_scaler as ls

    L, K = FUSED_LAYERS, FUSED_K
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkdv, fo.adam_step_)
    gen = torch.Generator(device="cuda").manual_seed(17)
    base = LlamaConfig.llama3_8b(num_hidden_layers=L, ce_chunk_size=8192)
    data = torch.randint(0, base.vocab_size, (2 * K, 1, FUSED_SEQ), generator=gen,
                         device="cuda")
    runs, checks = {}, {}

    def engine_of(config_extra=None, **model_over):
        cfg = LlamaConfig.llama3_8b(num_hidden_layers=L, ce_chunk_size=8192, **model_over)
        model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        config = {**FUSED_CONFIG, **(config_extra or {})}
        return deepspeed_tpu_torch.initialize(model=model, config=config)[0]

    def reset():
        for f in counted:
            f.launches = 0

    def launches():
        return {f.__name__: f.launches for f in counted}

    def window(engine, batch, check_sync):
        """One ``fused_train_steps`` call: its losses, the sizes the engine
        fetched and the wall seconds (the fetch waits for the device)."""
        fetches, fetch = [], engine._fetch

        def outside(t):
            torch.cuda.set_sync_debug_mode(0)
            fetches.append(int(t.numel()))
            return fetch(t)

        engine._fetch = outside
        torch.cuda.synchronize()
        t = time.monotonic()
        if check_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses = engine.fused_train_steps(batch, labels=batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del engine._fetch
        return losses.tolist(), fetches, time.monotonic() - t

    def sequential(engine, batches):
        losses, walls = [], []
        for x in batches:
            torch.cuda.synchronize()
            t = time.monotonic()
            loss = engine.forward(x, labels=x)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            walls.append(time.monotonic() - t)
        return losses, walls

    # (a) two bf16 windows against 2K sequential steps
    engine = engine_of()
    reset()
    l1, f1, _ = window(engine, data[:K], check_sync=True)
    l2, f2, wall = window(engine, data[K:], check_sync=False)
    win = {"losses": l1 + l2, "fetches": f1 + f2, "launches": launches(),
           "ms_per_step": 1e3 * wall / K, "lr": engine.get_lr(),
           "masters": engine.optimizer.params.clone()}
    win["profiled_window"] = busy_share(lambda: engine.fused_train_steps(data[:K],
                                                                         labels=data[:K]))
    del engine
    free_memory()
    engine = engine_of()
    reset()
    seq_losses, walls = sequential(engine, data)
    seq = {"losses": seq_losses, "launches": launches(), "lr": engine.get_lr(),
           "ms_per_step": 1e3 * sum(walls[K:]) / K}
    masters_equal = torch.equal(engine.optimizer.params, win.pop("masters"))
    free_memory()

    def one_step(x):
        loss = engine.forward(x, labels=x)
        engine.backward(loss)
        engine.step()
        return loss

    # the same K steps as the profiled window, each loss read as the
    # sequential run reads it
    seq["profiled_steps"] = busy_share(lambda: [one_step(x).item() for x in data[:K]])
    # (f) K7 over the whole flat buffer, then a set skip flag
    taken = capture_k7_inputs(engine)
    one_step(data[0])
    k7_path = k7_vs_plain_at_path_size(engine, taken)
    del taken
    free_memory()
    opt = engine.optimizer
    bufs = {"masters": opt.params, **opt.state}
    before = {k: fingerprint(v) for k, v in bufs.items()}
    grads = torch.full_like(opt.params, float("inf"))
    scalars = [fo.device_scalar(x, "cuda") for x in (opt.current_lr(), opt.count + 1)]
    skip_launches = fo.adam_step_.launches
    fo.adam_step_(opt.params, grads, opt.state["m"], opt.state["v"], *scalars, *opt.betas,
                  opt.eps, opt.weight_decay, skip=torch.ones(1, dtype=torch.bool,
                                                             device="cuda"))
    skip_kept = all(fingerprint(v) == before[k] for k, v in bufs.items())
    skip_launched = fo.adam_step_.launches == skip_launches + 1
    del grads, bufs
    runs["bf16_window"], runs["bf16_sequential"] = win, seq
    checks.update({
        "a_losses_bit_equal": win["losses"] == seq["losses"],
        "a_masters_bit_equal": masters_equal,
        "a_lr_equal": win["lr"] == seq["lr"],
        "a_one_fetch_per_window": win["fetches"] == [2 * K, 2 * K],
        "a_losses_finite": bool(np.isfinite(win["losses"]).all()),
        "a_launches_equal": win["launches"] == seq["launches"],
        "a_flash_L_and_k7_one_per_step": seq["launches"] == {
            "flash_attention_fwd": 2 * K * L, "flash_attention_bwd_dq": 2 * K * L,
            "flash_attention_bwd_dkdv": 2 * K * L, "adam_step_": 2 * K},
        "f_k7_at_path_size_within_ulps": k7_path["max_ulps"] <= K7_ULPS,
        "f_skip_flag_keeps_state": skip_kept and skip_launched,
    })
    del engine, opt
    free_memory()

    # (b) fp16: a window of all 2K batches against as many steps
    n16, fp16_data = 2 * K, data
    engine = engine_of(FUSED_FP16)
    reset()
    l16, f16, _ = window(engine, fp16_data, check_sync=True)
    w16 = {"losses": l16, "fetches": f16, "launches": launches(),
           "skipped_steps": engine.skipped_steps, "scale": ls.to_host(engine.scale_state),
           "lr": engine.get_lr(), "masters": engine.optimizer.params.clone()}
    del engine
    free_memory()
    engine = engine_of(FUSED_FP16)
    reset()
    s16_losses, _ = sequential(engine, fp16_data)
    s16 = {"losses": s16_losses, "launches": launches(), "skipped_steps": engine.skipped_steps,
           "scale": ls.to_host(engine.scale_state), "lr": engine.get_lr()}
    masters16 = torch.equal(engine.optimizer.params, w16.pop("masters"))
    w16["scale"], s16["scale"] = w16["scale"]._asdict(), s16["scale"]._asdict()
    runs["fp16_window"], runs["fp16_sequential"] = w16, s16
    checks.update({
        "b_some_steps_skipped_some_applied": 0 < w16["skipped_steps"] < n16,
        "b_skipped_steps_equal": w16["skipped_steps"] == s16["skipped_steps"],
        "b_scale_equal": w16["scale"] == s16["scale"],
        "b_lr_equal": w16["lr"] == s16["lr"],
        "b_masters_bit_equal": masters16,
        "b_losses_bit_equal": w16["losses"] == s16["losses"],
        "b_one_fetch": w16["fetches"] == [2 * n16],
        "b_k7_one_launch_per_step": w16["launches"]["adam_step_"] == n16,
    })
    del engine
    free_memory()

    # (c) gas 2: train_batch against its micro loop; (d) bf16 accumulation
    gas2 = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2}
    # three steps: the warmup's first learning rate is 0, so the third
    # loss is the first that an update moved
    micro = [(x, x) for x in data[:6]]

    def batches(engine):
        reset()
        out = [engine.train_batch(iter(micro[2 * i:2 * i + 2])) for i in range(3)]
        return out, launches(), engine._flat_grad

    engine = engine_of(gas2)
    tb_losses, tb_launches, acc = batches(engine)
    tb = {"losses": tb_losses, "launches": tb_launches, "buffer_bytes": acc.nbytes,
          "buffer_dtype": str(acc.dtype)}
    tb_masters = engine.optimizer.params.clone()
    del engine, acc
    free_memory()
    engine = engine_of(gas2)
    reset()
    loop = []
    for i in range(3):
        ls_ = []
        for x, y in micro[2 * i:2 * i + 2]:
            loss = engine.forward(x, y)
            engine.backward(loss)
            engine.step()
            ls_.append(loss.detach().float())
        loop.append(float((torch.zeros((), device="cuda") + ls_[0] + ls_[1]) / 2))
    loop_masters = torch.equal(engine.optimizer.params, tb_masters)
    del engine, tb_masters
    free_memory()
    engine = engine_of({**gas2, "data_types": {"grad_accum_dtype": "bf16"}})
    b16_losses, b16_launches, acc = batches(engine)
    b16 = {"losses": b16_losses, "launches": b16_launches, "buffer_bytes": acc.nbytes,
           "buffer_dtype": str(acc.dtype)}
    del engine, acc
    free_memory()
    rel = max(abs(a - b) / abs(b) for a, b in zip(b16["losses"], tb["losses"]))
    runs["gas2_train_batch"], runs["gas2_bf16_accum"] = tb, b16
    runs["gas2_micro_loop"] = {"losses": loop}
    b16["max_rel_loss_diff_vs_fp32"] = rel
    checks.update({
        "c_losses_bit_equal": tb["losses"] == loop,
        "c_masters_bit_equal": loop_masters,
        "c_k7_one_launch_per_step": tb["launches"]["adam_step_"] == 3,
        "d_buffer_half": 2 * b16["buffer_bytes"] == tb["buffer_bytes"]
        and b16["buffer_dtype"] == "torch.bfloat16",
        "d_losses_within_5e-3": rel <= 5e-3,
    })

    # (e) remat at 1 x REMAT_SEQ: three runs of 3 steps from the same weights
    rdata = torch.randint(0, base.vocab_size, (1, REMAT_SEQ), generator=gen, device="cuda")
    ref = None
    for name, over in REMAT_RUNS:
        engine = engine_of(**over)
        free_memory()
        state_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        reset()
        losses, walls, prints, first_grad = [], [], [], None
        for i in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            loss = engine.forward(rdata, labels=rdata)
            engine.backward(loss)
            torch.cuda.synchronize()
            mid = time.monotonic()
            prints.append(fingerprint(engine._flat_grad))
            if i == 0:
                first_grad = engine._flat_grad.clone() if ref is None else torch.equal(
                    engine._flat_grad, ref["first_grad"])
            torch.cuda.synchronize()
            t2 = time.monotonic()
            engine.step()
            torch.cuda.synchronize()
            walls.append(mid - t + time.monotonic() - t2)
            losses.append(loss.item())
        run = {"losses": losses, "grad_fingerprints": prints, "launches": launches(),
               "step_ms": 1e3 * sum(walls[1:]) / 2,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "state_gib": state_gib}
        run["activation_peak_gib"] = run["peak_memory_gib"] - state_gib
        k1 = 2 * L if over else L
        checks[f"e_{name}_launches_per_step"] = run["launches"] == {
            "flash_attention_fwd": 3 * k1, "flash_attention_bwd_dq": 3 * L,
            "flash_attention_bwd_dkdv": 3 * L, "adam_step_": 3}
        if ref is None:
            ref = {"losses": losses, "prints": prints, "first_grad": first_grad}
        else:
            checks[f"e_{name}_losses_bit_equal"] = losses == ref["losses"]
            checks[f"e_{name}_grads_bit_equal"] = first_grad and prints == ref["prints"]
        runs[f"remat_{name}"] = run
        del engine, loss
        free_memory()
    del ref
    free_memory()
    # every kernel of the path ran in every run that drives it
    for name, run in runs.items():
        if "launches" in run:
            checks[f"{name}_every_kernel_launched"] = all(run["launches"].values())
    rec = {"phase": "training_fused", "config": f"llama3_8b(num_hidden_layers={L}, "
           "ce_chunk_size=8192), random bf16 weights, AdamW lr 1e-4 wd 0.01 + "
           f"WarmupLR(linear, 4) + clip 1.0; windows of {K} x 1 x {FUSED_SEQ} tokens; "
           f"remat at 1 x {REMAT_SEQ}", "gpu": gpu_identity(), "runs": runs,
           "k7_path_check": k7_path, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"training_fused checks failed: {checks}")
    return rec



# the training_zero phase: Llama-3-8B's width cut to ZERO_LAYERS layers, bf16,
# AdamW with no clipping, the chunked CE and dots_saveable remat; 3 steps,
# then a 2-step fused_train_steps window (dryrun_multichip's order), on one
# global batch of ZERO_ROWS x ZERO_SEQ tokens a step
ZERO_LAYERS, ZERO_ROWS, ZERO_SEQ, ZERO_LR = 2, 2, 1024, 1e-4
ZERO_CONFIG = {"train_batch_size": ZERO_ROWS, "bf16": {"enabled": True},
               "optimizer": {"type": "AdamW", "params": {"lr": ZERO_LR, "weight_decay": 0.01}}}
# tests/test_torch_zero.py's bf16 tolerance against the single-process
# stage 0: the RMS of the master differences within 2^-4 of the learning
# rate's path and none beyond twice it; losses within 2^-7
ZERO_RMS, ZERO_MAX, ZERO_LOSS_RTOL = 2.0 ** -4, 2.0, 2.0 ** -7
# part (b): name, stage, mesh, steps (the pure data-parallel stage 0 and
# stage 2 run one step each, for each rank's peak memory and state beside
# stage 3's, stage 3 two, its masters against (a)'s stage 0 after as
# many: gloo moves every collective through host memory, 12-20 s a step at
# this size)
ZERO_RANK_STAGE3_STEPS = 2
ZERO_RANK_RUNS = (("stage0", 0, {"data": 2}, 1),
                  ("stage3", 3, {"fsdp": 2}, ZERO_RANK_STAGE3_STEPS),
                  ("stage2", 2, {"data": 2}, 1))


def zero_batches():
    """The phase's 5 global batches ``[5, ZERO_ROWS, ZERO_SEQ]``, drawn on
    the card from a seed (every process draws the same)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(18)
    return torch.randint(0, 128256, (5, ZERO_ROWS, ZERO_SEQ), generator=gen, device="cuda")


def zero_run(stage: int, mesh, after_step=None, check_sync: bool = False, steps: int = 5,
             arm=None):
    """One run of the phase at ``stage`` over ``mesh`` (None: the config
    names none): a fresh model from seed 0 through ``initialize``, 3
    forward/backward/step (``after_step(engine, i)`` after each) and a
    2-step ``fused_train_steps`` window, under
    ``set_sync_debug_mode("error")`` with ``check_sync`` (its one fetch
    outside); ``steps`` < 5 runs that many forward/backward/step only;
    ``arm(engine)`` just before the first step (the K7 check's capture).
    K7's count is set to 0 just before the steps and read just after.
    Returns the engine and the run's record."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    reset_mesh_context()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=ZERO_LAYERS, ce_chunk_size=8192, remat=True,
                                remat_policy="dots_saveable")
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    config = dict(ZERO_CONFIG, zero_optimization={"stage": stage})
    if mesh is not None:
        config["mesh"] = mesh
    t = time.monotonic()
    engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    torch.cuda.synchronize()
    rec = {"stage": stage, "mesh": mesh, "engine_build_s": time.monotonic() - t,
           "losses": [], "step_ms": []}
    data = zero_batches()
    torch.cuda.reset_peak_memory_stats()
    fo.adam_step_.launches = 0
    if arm is not None:
        arm(engine)
    for i in range(min(steps, 3)):
        torch.cuda.synchronize()
        t = time.monotonic()
        loss = engine.forward(data[i], labels=data[i])
        engine.backward(loss)
        engine.step()
        rec["losses"].append(loss.item())
        rec["step_ms"].append(1e3 * (time.monotonic() - t))
        if after_step is not None:
            after_step(engine, i)
    fetches, fetch = [], engine._fetch

    def outside(x):
        torch.cuda.set_sync_debug_mode(0)
        fetches.append(int(x.numel()))
        return fetch(x)

    if steps == 5:
        engine._fetch = outside
        torch.cuda.synchronize()
        t = time.monotonic()
        if check_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rec["losses"] += engine.fused_train_steps(data[3:], labels=data[3:]).tolist()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del engine._fetch
        rec["window_ms_per_step"] = 1e3 * (time.monotonic() - t) / 2
    rec["window_fetches"] = fetches
    rec["k7_launches"] = fo.adam_step_.launches
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["state_bytes"] = engine.state_bytes()
    return engine, rec


def master_fingerprints(engine) -> dict:
    """``fingerprint`` of each parameter's fp32 master (whole at world 1),
    by name (the ZeRO layout orders them by unit)."""
    return {name: fingerprint(m) for name, m in engine.master_params().items()}


def _zero_rank(rank: int, world: int, store: str, out_dir: str, ref, ref_bounds) -> None:
    """Part (b)'s rank: ``ZERO_RANK_RUNS`` over gloo with both ranks on
    the one card (NCCL over two cards where there are two), each run held
    against the single-process stage 0's final masters ``ref`` (shared
    from the parent through CUDA IPC; ``ref_bounds`` each parameter's
    range in it). Rank 1 holds its engine's K7 launch at its shard's
    length against the plain version. Writes its record to ``out_dir``."""
    import torch
    sys.path.insert(0, ROOT)
    from deepspeed_tpu_torch import comm
    two_cards = torch.cuda.device_count() >= 2
    os.environ["LOCAL_RANK"] = str(rank if two_cards else 0)  # init_distributed's device
    comm.init_distributed(dist_backend="nccl" if two_cards else "gloo",
                          init_method=f"file://{store}", rank=rank, world_size=world)
    out = {"rank": rank, "backend": "nccl on two cards" if two_cards else "gloo on one card",
           "runs": {}}
    for name, stage, mesh, steps in ZERO_RANK_RUNS:
        taken = {}

        def arm(engine, stage=stage):
            """Rank 1 at stage 3: the first step's K7 launch on this rank's
            shard, against the plain version right after it."""
            if stage == 3 and rank == 1:
                taken["inputs"] = capture_k7_inputs(engine)

        def check(engine, i):
            if i == 0 and "inputs" in taken:
                taken["check"] = dict(k7_vs_plain_at_path_size(engine, taken.pop("inputs")),
                                      shard_numel=engine.layout.shard_numel)

        engine, rec = zero_run(stage, mesh, after_step=check, steps=steps, arm=arm)
        if "check" in taken:
            rec["k7_shard_check"] = taken.pop("check")
        sq, worst, n = 0.0, 0.0, 0
        for i, s, e, off in (engine.layout.pieces if steps == ZERO_RANK_STAGE3_STEPS else []):
            a = ref_bounds[i][0] + off
            d = engine._flat_master[s:e] - ref[a:a + e - s]
            sq += float(d.double().square().sum())
            worst = max(worst, float(d.abs().max()))
            n += e - s
        rec["master_rms_diff"], rec["master_max_diff"] = (sq / max(n, 1)) ** 0.5, worst
        rec["shard_numel"], rec["full_numel"] = engine.layout.shard_numel, engine.layout.full_numel
        rec["zero_size"] = engine.layout.zero_size
        out["runs"][name] = rec
        del engine
        free_memory()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_training_zero() -> dict:
    """ZeRO stages 1-3 over the named mesh at the Llama-3-8B width
    (``ZERO_LAYERS`` layers, bf16, AdamW, chunked CE, dots_saveable remat;
    3 steps and a 2-step window each run):
    (a) world 1 over NCCL in this process (a ``file://`` store): stages 0,
    1, 2 and 3 from the same weights, the losses and each parameter's fp32
    master bit-equal to stage 0's after every step (with one rank every
    collective is a copy), each window under
    ``set_sync_debug_mode("error")``; (b) two ranks spawned on the one card
    over gloo (NCCL on two cards where there are two): stage 0 over
    ``{data: 2}``, stage 3 over ``{fsdp: 2}`` and stage 2 over ``{data:
    2}`` (stages 0 and 2 one step each, stage 3 two), losses against
    (a)'s stage 0 and stage 3's masters against its masters after two
    steps, within the bf16 tolerance of tests/test_torch_zero.py, each rank's flat state at stages
    2-3 half of stage 0's plus padding, K7 once per step on each rank and,
    on rank 1, its stage-3 launch held against the plain version at its
    shard's length; each rank's peak memory at stages 0 and 3 and the step
    times (gloo on one card: not a speed of NCCL). The process group is
    destroyed at the end; a failed check or a dead rank fails the phase."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.comm import reset_mesh_context
    tmp = tempfile.mkdtemp(prefix="zero_", dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store1')}",
                            rank=0, world_size=1)
    runs, checks, prints = {}, {}, {}
    ref = ref_bounds = None
    try:
        for stage in (0, 1, 2, 3):
            step_prints = []

            def record(engine, i, stage=stage):
                step_prints.append(master_fingerprints(engine))
                if stage == 0 and i == ZERO_RANK_STAGE3_STEPS - 1:  # (b)'s reference
                    nonlocal ref, ref_bounds
                    ref = engine._flat_master.clone()
                    ref_bounds = [list(b) for b in engine.layout.full_bounds]

            engine, rec = zero_run(stage, None, after_step=record, check_sync=True)
            record(engine, 3)
            prints[stage] = step_prints
            runs[f"a_world1_stage{stage}"] = rec
            del engine
            free_memory()
        for stage in (1, 2, 3):
            rec, base = runs[f"a_world1_stage{stage}"], runs["a_world1_stage0"]
            checks[f"a_stage{stage}_losses_bit_equal"] = rec["losses"] == base["losses"]
            checks[f"a_stage{stage}_masters_bit_equal_every_step"] = prints[stage] == prints[0]
        for stage in (0, 1, 2, 3):
            rec = runs[f"a_world1_stage{stage}"]
            checks[f"a_stage{stage}_window_one_fetch_no_sync"] = rec["window_fetches"] == [4]
            checks[f"a_stage{stage}_k7_one_launch_per_step"] = rec["k7_launches"] == 5
    finally:
        dist.destroy_process_group()
        reset_mesh_context()
    free_memory()
    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=tmp)
    t = time.monotonic()
    mp.start_processes(_zero_rank, args=(2, os.path.join(tmp, "store2"), out_dir, ref, ref_bounds),
                       nprocs=2, start_method="spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    spawn_s = time.monotonic() - t
    del ref
    free_memory()
    base = runs["a_world1_stage0"]
    path = ZERO_RANK_STAGE3_STEPS * ZERO_LR
    for rk in ranks:
        r = rk["rank"]
        full_state = rk["runs"]["stage0"]["state_bytes"]
        for name, rec in rk["runs"].items():
            tag = f"b_rank{r}_{name}"
            rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], base["losses"]))
            rec["max_rel_loss_diff_vs_stage0"] = rel
            checks[f"{tag}_losses_within_tolerance"] = rel <= ZERO_LOSS_RTOL
            n_steps = len(rec["losses"])
            checks[f"{tag}_k7_one_launch_per_step"] = rec["k7_launches"] == n_steps
            if n_steps == ZERO_RANK_STAGE3_STEPS:  # against (a)'s stage 0 after as many
                checks[f"{tag}_masters_within_tolerance"] = (
                    rec["master_rms_diff"] <= ZERO_RMS * path
                    and rec["master_max_diff"] <= ZERO_MAX * path)
            if rec["stage"] >= 2:
                b = rec["state_bytes"]
                # padding beyond stage 0's: each unit to 2 x 64 elements
                half = full_state["masters"] / 2
                extra = 4 * rec["full_numel"] - full_state["masters"]
                checks[f"{tag}_state_half_plus_padding"] = (
                    rec["zero_size"] == 2 and 0 <= extra <= 4 * 128 * 8
                    and b["masters"] == b["m"] == b["v"] == b["grad_acc"] == half + extra / 2)
            if rec["stage"] == 3:
                checks[f"{tag}_compute_copy_sharded"] = (
                    rec["state_bytes"]["compute"] < full_state["masters"] / 4 + 2**20)
        if r == 1:
            shard = rk["runs"]["stage3"]["k7_shard_check"]
            checks["b_rank1_k7_at_shard_within_ulps"] = shard["max_ulps"] <= K7_ULPS
    checks["b_backend_named"] = all(rk["backend"] for rk in ranks)
    rec = {"phase": "training_zero", "config": f"llama3_8b(num_hidden_layers={ZERO_LAYERS}, "
           "ce_chunk_size=8192, remat dots_saveable), random bf16 weights, AdamW lr "
           f"{ZERO_LR} wd 0.01, no clipping; 3 steps + a 2-step window of {ZERO_ROWS} x "
           f"{ZERO_SEQ} tokens", "gpu": gpu_identity(), "runs": runs,
           "ranks": ranks, "b_spawn_s": spawn_s, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    for rk in ranks:  # the numbers the phase reports, each on a line of its own
        for name, run in rk["runs"].items():
            emit({"training_zero_rank": rk["rank"], "run": name, "backend": rk["backend"],
                  "step_ms_" + rk["backend"].replace(" ", "_"): run["step_ms"],
                  "peak_memory_gib": run["peak_memory_gib"], "state_bytes": run["state_bytes"],
                  "stage0_state_bytes": rk["runs"]["stage0"]["state_bytes"]})
    if not rec["ok"]:
        raise SystemExit(f"training_zero checks failed: {checks}")
    return rec


# the training_grad_comm phase: the training_zero phase's model (Llama-3-8B
# width, ZERO_LAYERS layers, bf16, the chunked CE, dots_saveable remat) at
# gas 2 through the bucketed gradient wire (gradient_comm), on the same
# global batch of ZERO_ROWS x ZERO_SEQ tokens a micro-step
GC_GAS, GC_STEPS = 2, 2
GC_ADAMW = ZERO_CONFIG["optimizer"]


def wire_section(tier: str, overlap: bool) -> dict:
    return {"enabled": True, "comm_quantization": tier, "overlap_comm": overlap}


# part (b): name, stage, gradient_comm (None: the default reduce), gas,
# steps, optimizer
GC_RANK_RUNS = (
    ("fp32_s2_overlap", 2, wire_section("fp32", True), GC_GAS, 1, GC_ADAMW),
    ("int8_s1_overlap", 1, wire_section("int8", True), GC_GAS, 1, GC_ADAMW),
    ("onebit_s0_boundary", 0, wire_section("onebit", False), GC_GAS, 1, GC_ADAMW),
    ("onebitadam_wire", 0, None, 1, 4,
     {"type": "OneBitAdam", "params": {"lr": ZERO_LR, "weight_decay": 0.01, "freeze_step": 2,
                                       "comm_backend_name": "nccl"}}),
    ("muadamw_s1", 1, None, 1, 1, {"type": "MuAdamW", "params": {"lr": ZERO_LR,
                                                                 "weight_decay": 0.01}}),
)


def gc_batches(n: int):
    """``n`` micro-batches ``[n, ZERO_ROWS, ZERO_SEQ]`` drawn on the card
    from a seed (every process draws the same)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(19)
    return torch.randint(0, 128256, (n, ZERO_ROWS, ZERO_SEQ), generator=gen, device="cuda")


def half_width_shapes(model) -> dict:
    """muP's base shapes: each of ``model``'s shapes at half its width
    (every dimension but the vocabulary's halved)."""
    from deepspeed_tpu_torch.runtime.mup import make_base_shapes
    return {k: [d if d == 128256 else d // 2 for d in shape]
            for k, shape in make_base_shapes(model).items()}


def gc_run(stage: int, wire_cfg, gas: int, steps: int, optimizer, mesh=None, check_sync=False,
           after_step=None, arm=None):
    """One run: a fresh model from seed 0 through ``initialize`` at
    ``stage`` with ``gradient_comm`` section ``wire_cfg`` (None: none) and the
    comms logger banking the wire's bytes (its collectives untimed), then
    ``steps`` ``train_batch`` calls of ``gas`` micro-batches, each under
    ``set_sync_debug_mode("error")`` with ``check_sync`` (its one fetch
    outside); ``arm(engine)`` just before the first step. K7's counts are
    set to 0 just before the steps and read just after. Returns the engine
    and the run's record."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import bucketing, reset_mesh_context
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    reset_mesh_context()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=ZERO_LAYERS, ce_chunk_size=8192, remat=True,
                                remat_policy="dots_saveable")
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    if optimizer["type"] == "MuAdamW":
        optimizer = {"type": "MuAdamW", "params": dict(optimizer["params"],
                                                       base_shapes=half_width_shapes(model))}
    config = {"train_batch_size": ZERO_ROWS * gas, "gradient_accumulation_steps": gas,
              "bf16": {"enabled": True}, "optimizer": optimizer,
              "zero_optimization": {"stage": stage},
              "comms_logger": {"enabled": True, "prof_all": False}}
    if wire_cfg is not None:
        config["gradient_comm"] = wire_cfg
    if mesh is not None:
        config["mesh"] = mesh
    t = time.monotonic()
    engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    torch.cuda.synchronize()
    logger = get_comms_logger()
    logger.comms_dict = {}
    rec = {"stage": stage, "mesh": mesh, "gradient_comm": wire_cfg, "gas": gas,
           "optimizer": optimizer["type"], "engine_build_s": time.monotonic() - t,
           "wired": engine._wire is not None, "onebit_wire": engine._onebit_wire,
           "losses": [], "step_ms": [], "fetches": []}
    data = gc_batches(steps * gas)
    fetch = engine._fetch

    def outside(x):
        torch.cuda.set_sync_debug_mode(0)
        rec["fetches"].append(int(x.numel()))
        return fetch(x)

    engine._fetch = outside
    torch.cuda.reset_peak_memory_stats()
    fo.adam_step_.launches = fo.lamb_update_.launches = 0
    if arm is not None:
        arm(engine)
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.monotonic()
        if check_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rec["losses"].append(engine.train_batch(iter(
                [(data[i * gas + j], data[i * gas + j]) for j in range(gas)])))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rec["step_ms"].append(1e3 * (time.monotonic() - t))
        if after_step is not None:
            after_step(engine, i)
    del engine._fetch
    rec["k7_launches"] = fo.adam_step_.launches
    rec["lamb_update_launches"] = fo.lamb_update_.launches
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["state_bytes"] = engine.state_bytes()
    if engine._wire is not None:
        w = engine.dp_world_size
        tier = wire_cfg["comm_quantization"]
        per_step = bucketing.bucket_wire_bytes(engine._bucket_layout, w, tier)
        banked = logger.comms_dict.get(f"bucketed_grad_comm[{tier}]", {})
        rec["wire"] = {"stats": dict(engine._wire.stats), "bucket_wire_bytes": per_step,
                       "banked": {str(size): v[0] for size, v in banked.items()},
                       "n_buckets": len(engine._bucket_layout.buckets)}
    if engine._onebit_wire:  # the compressed momentum: each parameter's signs and scale
        from deepspeed_tpu_torch.comm.compressed import wire_bytes
        rec["onebit_wire_bytes_a_step"] = sum(
            wire_bytes(p.numel(), engine.dp_world_size)["compressed_bytes"]
            for p in engine._params)
        rec["error_feedback_moved"] = bool(  # a reduction: no temporary of the state's size
            torch.linalg.vector_norm(engine.optimizer.state["error"], float("inf")) > 0)
    if optimizer["type"] == "MuAdamW":
        rec["multipliers"] = sorted(set(engine.optimizer._mults()))
    return engine, rec


def _gc_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """Part (b)'s rank: ``GC_RANK_RUNS`` over gloo with both ranks on the
    one card (NCCL over two cards where there are two). Rank 1 holds the
    fp32 tier's second K7 launch, on its shard of the bucket-laid state,
    against the plain version. Writes its record to ``out_dir`` after each
    run. Two ranks' engines share the card: the allocator grows its
    segments, so freed blocks are reused across sizes."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    sys.path.insert(0, ROOT)
    from deepspeed_tpu_torch import comm
    two_cards = torch.cuda.device_count() >= 2
    os.environ["LOCAL_RANK"] = str(rank if two_cards else 0)
    comm.init_distributed(dist_backend="nccl" if two_cards else "gloo",
                          init_method=f"file://{store}", rank=rank, world_size=world)
    out = {"rank": rank, "backend": "nccl on two cards" if two_cards else "gloo on one card",
           "runs": {}}
    for name, stage, wire_cfg, gas, steps, optimizer in GC_RANK_RUNS:
        taken = {}

        def arm(engine, name=name):
            if name == "fp32_s2_overlap" and rank == 1:
                taken["inputs"] = capture_k7_inputs(engine)

        def check(engine, i):
            if i == 0 and "inputs" in taken:
                taken["check"] = dict(k7_vs_plain_at_path_size(engine, taken.pop("inputs")),
                                      shard_numel=engine.layout.shard_numel)

        engine, rec = gc_run(stage, wire_cfg, gas, steps, optimizer, mesh={"data": world},
                             after_step=check, arm=arm)
        if "check" in taken:
            rec["k7_shard_check"] = taken.pop("check")
        rec["shard_numel"], rec["full_numel"] = engine.layout.shard_numel, engine.layout.full_numel
        out["runs"][name] = rec
        del engine
        free_memory()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_training_grad_comm() -> dict:
    """The bucketed gradient wire, the 1-bit optimizers' wire and muP at
    the Llama-3-8B width (``ZERO_LAYERS`` layers, bf16, AdamW on K7, the
    chunked CE, gas 2): (a) world 1 over NCCL in this process: the default
    reduce at stage 0, then the fp32 tier at stages 0, 1 and 2 with and
    without overlap, each step under ``set_sync_debug_mode("error")``, its
    losses and every master bit-equal to the default reduce's after each
    step (one rank: the same additions in the same order), K7 once a step
    (stage 3 under the wire is the scheduled store:
    ``training_zero3_scheduled``). (b) Two ranks spawned on the one card
    over gloo (not a speed of NCCL), one step each: the fp32 tier with
    overlap at stage 2, int8 with overlap at stage 1, onebit at the
    boundary at stage 0, muadamw with the base shapes of half the width
    (stage 1); and 1-bit Adam with ``comm_backend_name`` (freeze_step 2,
    4 steps).
    Checks: the fp32 tier's losses within the bf16 tolerance of (a); a
    quantized tier's within the JAX tests' 0.05 of it; each step's wire
    bytes banked as ``bucket_wire_bytes``; K7 once a step a rank (1-bit
    Adam: its 2 warmup steps; muadamw: K7's Adam pass); rank 1's K7 on its
    bucket-laid shard within ``K7_ULPS`` of the plain version. Prints per
    run the step ms, the wire bytes and the peak GiB."""
    import math
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.comm import reset_mesh_context
    tmp = tempfile.mkdtemp(prefix="grad_comm_", dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store1')}",
                            rank=0, world_size=1)
    runs, checks, prints = {}, {}, {}
    try:
        for stage, overlap in ((0, None), (0, True), (0, False), (1, True), (1, False),
                               (2, True), (2, False)):
            wire_cfg = None if overlap is None else wire_section("fp32", overlap)
            name = ("default_s0" if wire_cfg is None
                    else f"fp32_s{stage}_{'overlap' if overlap else 'boundary'}")
            step_prints = []
            engine, rec = gc_run(stage, wire_cfg, GC_GAS, GC_STEPS, GC_ADAMW, check_sync=True,
                                 after_step=lambda e, i: step_prints.append(
                                     master_fingerprints(e)))
            prints[name] = step_prints
            runs[f"a_world1_{name}"] = rec
            del engine
            free_memory()
        base = runs["a_world1_default_s0"]
        for name in prints:
            rec = runs[f"a_world1_{name}"]
            checks[f"a_{name}_one_fetch_a_step_no_sync"] = rec["fetches"] == [2] * GC_STEPS
            checks[f"a_{name}_k7_once_a_step"] = rec["k7_launches"] == GC_STEPS
            if name == "default_s0":
                checks["a_default_s0_not_wired"] = not rec["wired"]
                continue
            checks[f"a_{name}_wired"] = rec["wired"]
            checks[f"a_{name}_losses_bit_equal"] = rec["losses"] == base["losses"]
            checks[f"a_{name}_masters_bit_equal_every_step"] = (
                prints[name] == prints["default_s0"])
    finally:
        dist.destroy_process_group()
        reset_mesh_context()
    emit({"training_grad_comm_a": checks})
    free_memory()
    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=tmp)
    t = time.monotonic()
    mp.start_processes(_gc_rank, args=(2, os.path.join(tmp, "store2"), out_dir), nprocs=2,
                       start_method="spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    spawn_s = time.monotonic() - t
    base = runs["a_world1_default_s0"]["losses"]
    for rk in ranks:
        for name, rec in rk["runs"].items():
            tag = f"b_rank{rk['rank']}_{name}"
            n = len(rec["losses"])
            rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], base))
            rec["max_rel_loss_diff_vs_a"] = rel
            finite = all(math.isfinite(x) for x in rec["losses"])
            if name.startswith("fp32"):
                checks[f"{tag}_losses_within_bf16_tolerance"] = finite and rel <= ZERO_LOSS_RTOL
            elif rec["gradient_comm"] is not None:
                checks[f"{tag}_losses_within_0.05"] = finite and rel <= 0.05
            else:
                checks[f"{tag}_losses_finite"] = finite
            if rec["gradient_comm"] is not None:
                wire = rec["wire"]
                per_step = wire["bucket_wire_bytes"]["wire_bytes"]
                checks[f"{tag}_wired"] = rec["wired"]
                checks[f"{tag}_wire_bytes_each_step"] = (
                    wire["stats"] == {"steps": n, "wire_bytes": n * per_step}
                    and wire["banked"] == {str(per_step): n})
                checks[f"{tag}_k7_once_a_step"] = rec["k7_launches"] == n
            elif rec["optimizer"] == "OneBitAdam":
                checks[f"{tag}_wire_engaged"] = rec["onebit_wire"]
                checks[f"{tag}_k7_at_the_warmup_steps"] = rec["k7_launches"] == 2
                checks[f"{tag}_error_feedback_moved"] = rec["error_feedback_moved"]
            else:
                checks[f"{tag}_k7_adam_pass_once_a_step"] = rec["lamb_update_launches"] == n
                checks[f"{tag}_half_width_multipliers"] = 0.5 in rec["multipliers"]
        ratio = {t: rk["runs"][f"{t}"]["wire"]["bucket_wire_bytes"] for t in
                 ("int8_s1_overlap", "onebit_s0_boundary")}
        rk["wire_ratio_vs_fp32"] = {t: v["wire_bytes"] / v["fp32_bytes"] for t, v in ratio.items()}
    shard = ranks[1]["runs"]["fp32_s2_overlap"]["k7_shard_check"]
    checks["b_rank1_k7_at_bucket_shard_within_ulps"] = shard["max_ulps"] <= K7_ULPS
    checks["b_backend_named"] = all(rk["backend"] for rk in ranks)
    rec = {"phase": "training_grad_comm", "config": f"llama3_8b(num_hidden_layers={ZERO_LAYERS}, "
           "ce_chunk_size=8192, remat dots_saveable), random bf16 weights, AdamW lr "
           f"{ZERO_LR} wd 0.01, no clipping; {ZERO_ROWS} x {ZERO_SEQ} tokens a micro-step",
           "gpu": gpu_identity(), "runs": runs, "ranks": ranks, "b_spawn_s": spawn_s,
           "checks": checks, "ok": all(checks.values())}
    emit(rec)
    for rk in ranks:  # per run: step ms, wire bytes, peak GiB, each on a line of its own
        for name, run in rk["runs"].items():
            emit({"training_grad_comm_rank": rk["rank"], "run": name, "backend": rk["backend"],
                  "step_ms_" + rk["backend"].replace(" ", "_"): run["step_ms"],
                  "wire_bytes_a_step": (run["wire"]["bucket_wire_bytes"]["wire_bytes"]
                                        if "wire" in run else run.get("onebit_wire_bytes_a_step")),
                  "peak_memory_gib": run["peak_memory_gib"], "state_bytes": run["state_bytes"]})
    if not rec["ok"]:
        raise SystemExit(f"training_grad_comm checks failed: {checks}")
    return rec


# the training_zero3_scheduled and training_checkpoint phases: the
# training_zero phase's model (Llama-3-8B width, ZERO_LAYERS layers, bf16,
# the chunked CE) and global batch of ZERO_ROWS x ZERO_SEQ tokens a
# micro-step, without remat (the store refuses it: a recomputed layer reads
# its parameters outside the schedule), AdamW with no clipping
Z3_GAS, Z3_STEPS = 2, 3
Z3_RANK_STEPS = 1  # part (b)'s steps: gloo moves 3 GB a gather through host memory
Z3_WIRE = {"enabled": True, "comm_quantization": "fp32", "overlap_comm": True}


def z3_run(stage: int, zero_extra=None, gas: int = Z3_GAS, steps: int = Z3_STEPS, mesh=None,
           check_sync: bool = False, after_step=None, data=None, arm=None):
    """One run: a fresh model from seed 0 through ``initialize`` at
    ``stage`` under the fp32 gradient wire (at stage 3 the scheduled store,
    persistence threshold 0 unless ``zero_extra`` sets one), ``steps``
    ``train_batch`` calls of ``gas`` micro-batches; steps after the first
    (which traces the schedule) under ``set_sync_debug_mode("error")``
    with ``check_sync``, each step's fetch outside; ``arm(engine)`` just
    before the first step. K7's and K1/K2's counts are set to 0 just before
    the steps and read just after. Returns the engine and the run's
    record."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import attention as fa
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    reset_mesh_context()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=ZERO_LAYERS, ce_chunk_size=8192)
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    zero = {"stage": stage, "stage3_param_persistence_threshold": 0}
    zero.update(zero_extra or {})
    config = {"train_batch_size": ZERO_ROWS * gas, "gradient_accumulation_steps": gas,
              "bf16": {"enabled": True}, "optimizer": GC_ADAMW, "zero_optimization": zero,
              "gradient_comm": dict(Z3_WIRE)}
    if mesh is not None:
        config["mesh"] = mesh
    t = time.monotonic()
    engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    torch.cuda.synchronize()
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
               fo.adam_step_)
    rec = {"stage": stage, "zero": zero, "mesh": mesh, "gas": gas,
           "engine_build_s": time.monotonic() - t, "store": engine._store is not None,
           "losses": [], "step_ms": [], "fetches": []}
    data = gc_batches(steps * gas) if data is None else data
    fetch = engine._fetch

    def outside(x):
        torch.cuda.set_sync_debug_mode(0)
        rec["fetches"].append(int(x.numel()))
        return fetch(x)

    engine._fetch = outside
    torch.cuda.reset_peak_memory_stats()
    for f in counted:
        f.launches = 0
    if arm is not None:
        arm(engine)
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.monotonic()
        if check_sync and i > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rec["losses"].append(engine.train_batch(iter(
                [(data[i * gas + j], data[i * gas + j]) for j in range(gas)])))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rec["step_ms"].append(1e3 * (time.monotonic() - t))
        if after_step is not None:
            after_step(engine, i)
    del engine._fetch
    rec["launches"] = {f.__name__: f.launches for f in counted}
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["state_bytes"] = engine.state_bytes()
    if engine._store is not None and engine._zero3_schedule is not None:
        sched, meta = engine._zero3_schedule, engine._zero3_store
        rec["schedule"] = {"epochs": len(sched.epochs), "buckets": len(meta.layout.buckets),
                           "prefetches": sched.prefetch_count,
                           "peak_live_elements": sched.peak_live_elements,
                           "max_live_parameters": engine._config.zero_config.max_live_parameters,
                           "gather_wire_bytes_a_microbatch": sched.gather_wire_bytes,
                           "persistent_elements": sched.persistent_elements}
        rec["padded_elements"] = sum(b.padded_size for b in meta.layout.buckets)
        rec["store_stats"] = dict(engine._store.stats)
        rec["tiers"] = [engine._store.fwd_tier, engine._store.bwd_tier]
    return engine, rec


def _z3_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """Part (b)'s rank: the store over ``{data: 2}`` with both ranks on
    the one card over gloo (NCCL over two cards where there are two),
    ``Z3_RANK_STEPS`` steps; rank 1 holds its first K7 launch, on its half
    of the store, against the plain version. Writes its record to
    ``out_dir``."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    sys.path.insert(0, ROOT)
    from deepspeed_tpu_torch import comm
    two_cards = torch.cuda.device_count() >= 2
    os.environ["LOCAL_RANK"] = str(rank if two_cards else 0)
    comm.init_distributed(dist_backend="nccl" if two_cards else "gloo",
                          init_method=f"file://{store}", rank=rank, world_size=world)
    out = {"rank": rank, "backend": "nccl on two cards" if two_cards else "gloo on one card"}
    taken = {}

    def arm(engine):
        if rank == 1:
            taken["inputs"] = capture_k7_inputs(engine)

    def check(engine, i):
        if i == 0 and "inputs" in taken:
            taken["check"] = dict(k7_vs_plain_at_path_size(engine, taken.pop("inputs")),
                                  shard_numel=engine.layout.shard_numel)

    engine, rec = z3_run(3, steps=Z3_RANK_STEPS, mesh={"data": world}, after_step=check,
                         arm=arm, data=gc_batches(Z3_STEPS * Z3_GAS))  # (a)'s batches
    if "check" in taken:
        rec["k7_shard_check"] = taken.pop("check")
    out["run"] = rec
    del engine
    free_memory()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_training_zero3_scheduled() -> dict:
    """The scheduled ZeRO-3 store (``runtime/zero3_schedule.py``) at the
    Llama-3-8B width (``ZERO_LAYERS`` layers, bf16, AdamW on K7, the
    chunked CE, gas 2, no remat): (a) world 1 over NCCL in this process:
    the stage-2 wire, then the store under the fp32 wire, from the same
    weights; the store's losses and every master bit-equal to the stage-2
    wire's after each step (one rank: the same additions in the same
    order), one fetch a step, K7 once a step, each K1/K2 once a layer and
    micro-step (and K1 once a layer for the schedule's trace at the first
    step), K7's second launch held against the plain version over the
    store's whole shard; the schedule's epochs, prefetches, gathered peak
    against ``stage3_max_live_parameters`` and wire bytes; the store with
    the int8 tiers (``zero_quantized_weights`` and
    ``zero_quantized_gradients``) within the JAX tests' 0.05 of the fp32
    store's losses; K1 and both K2 passes held against their plain
    versions at the path's shape (2 x 1024, H 32, KV 8, D 128). (b) Two
    ranks spawned on the one card over gloo (not a speed of NCCL), the
    store over ``{data: 2}`` for ``Z3_RANK_STEPS`` steps: losses against
    (a)'s store within the bf16 tolerance of tests/test_torch_zero.py,
    each rank's masters and moments 4 x padded /
    2 bytes, rank 1's K7 on its half held against the plain version. Prints
    per run the step ms, the schedule's figures and the peak GiB."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.comm import reset_mesh_context
    tmp = tempfile.mkdtemp(prefix="zero3_", dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store1')}",
                            rank=0, world_size=1)
    runs, checks, prints = {}, {}, {}
    taken = {}

    def arm(engine, i):
        prints["store"].append(master_fingerprints(engine))
        if i == 0:
            taken["inputs"] = capture_k7_inputs(engine)
        elif i == 1:
            taken["check"] = dict(k7_vs_plain_at_path_size(engine, taken.pop("inputs")),
                                  shard_numel=engine.layout.shard_numel)

    try:
        prints["stage2"], prints["store"] = [], []
        engine, runs["a_stage2_wire"] = z3_run(
            2, check_sync=True, after_step=lambda e, i: prints["stage2"].append(
                master_fingerprints(e)))
        del engine
        free_memory()
        engine, rec = z3_run(3, check_sync=True, after_step=arm)
        rec["k7_store_check"] = taken.pop("check")
        runs["a_store_fp32"] = rec
        del engine
        free_memory()
        engine, runs["a_store_int8"] = z3_run(3, {"zero_quantized_weights": True,
                                                  "zero_quantized_gradients": True})
        del engine
        free_memory()
        gen = torch.Generator(device="cuda").manual_seed(20)
        flash = _flash_case(gen, "zero3_store_2x1024", ZERO_ROWS, ZERO_SEQ, True)
    finally:
        dist.destroy_process_group()
        reset_mesh_context()
    free_memory()
    s2, s3, q = runs["a_stage2_wire"], runs["a_store_fp32"], runs["a_store_int8"]
    L, n = ZERO_LAYERS, Z3_STEPS * Z3_GAS
    checks["a_store_engaged"] = s3["store"] and q["store"] and not s2["store"]
    checks["a_store_losses_bit_equal_stage2_wire"] = s3["losses"] == s2["losses"]
    checks["a_store_masters_bit_equal_every_step"] = prints["store"] == prints["stage2"]
    for name, rec in (("stage2_wire", s2), ("store_fp32", s3), ("store_int8", q)):
        checks[f"a_{name}_one_fetch_a_step_no_sync"] = rec["fetches"] == [2] * Z3_STEPS
        checks[f"a_{name}_k7_once_a_step"] = rec["launches"]["adam_step_"] == Z3_STEPS
        trace = L if rec["store"] else 0  # the schedule pass's forward at the first step
        checks[f"a_{name}_flash_once_a_layer_and_microstep"] = rec["launches"] == {
            "flash_attention_fwd": n * L + trace, "flash_attention_bwd_dq": n * L,
            "flash_attention_bwd_dkdv": n * L, "adam_step_": Z3_STEPS}
    sched = s3["schedule"]
    checks["a_schedule_every_bucket_gathered"] = sched["epochs"] >= sched["buckets"]
    checks["a_schedule_peak_within_budget"] = (sched["peak_live_elements"]
                                               <= sched["max_live_parameters"])
    checks["a_store_gathers_counted"] = (s3["store_stats"]["gathers"]
                                         == sched["epochs"] * n)
    checks["a_int8_tiers"] = q["tiers"] == ["int8", "int8"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(q["losses"], s3["losses"]))
    q["max_rel_loss_diff_vs_fp32_store"] = rel
    checks["a_int8_losses_within_0.05"] = rel <= 0.05 and q["losses"] != s3["losses"]
    checks["a_k7_at_store_shard_within_ulps"] = s3["k7_store_check"]["max_ulps"] <= K7_ULPS
    checks["a_flash_at_path_shape"] = all(
        flash[key]["row_rel_err"] <= flash["row_tolerance"]
        and flash["lse_max_abs_err"] <= LSE_TOL
        and flash[key]["vs_exact"]["kernel"] <= FLASH_EXACT_RATIO * flash[key]["vs_exact"]["plain"]
        for key, _, _ in FLASH_KERNELS)
    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=tmp)
    t = time.monotonic()
    mp.start_processes(_z3_rank, args=(2, os.path.join(tmp, "store2"), out_dir), nprocs=2,
                       start_method="spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    spawn_s = time.monotonic() - t
    for rk in ranks:
        rec, tag = rk["run"], f"b_rank{rk['rank']}"
        rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], s3["losses"]))
        rec["max_rel_loss_diff_vs_a"] = rel
        checks[f"{tag}_store_engaged"] = rec["store"]
        checks[f"{tag}_losses_within_bf16_tolerance"] = rel <= ZERO_LOSS_RTOL
        b, share = rec["state_bytes"], 4 * rec["padded_elements"] // 2
        checks[f"{tag}_half_of_the_store"] = b["masters"] == b["m"] == b["v"] == share
        checks[f"{tag}_k7_once_a_step"] = rec["launches"]["adam_step_"] == Z3_RANK_STEPS
        checks[f"{tag}_gather_wire_bytes"] = rec["schedule"]["gather_wire_bytes_a_microbatch"] > 0
    shard = ranks[1]["run"]["k7_shard_check"]
    checks["b_rank1_k7_at_half_store_within_ulps"] = shard["max_ulps"] <= K7_ULPS
    checks["b_backend_named"] = all(rk["backend"] for rk in ranks)
    rec = {"phase": "training_zero3_scheduled",
           "config": f"llama3_8b(num_hidden_layers={ZERO_LAYERS}, ce_chunk_size=8192), random "
           f"bf16 weights, AdamW lr {ZERO_LR} wd 0.01, no clipping, no remat; gas {Z3_GAS} x "
           f"{ZERO_ROWS} x {ZERO_SEQ} tokens; stage3_param_persistence_threshold 0",
           "gpu": gpu_identity(), "runs": runs, "ranks": ranks, "flash_case": flash,
           "b_spawn_s": spawn_s, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    for name, run in runs.items():  # step ms, the schedule, peak GiB
        emit({"training_zero3_scheduled_run": name, "step_ms": run["step_ms"],
              "schedule": run.get("schedule"), "peak_memory_gib": run["peak_memory_gib"],
              "state_bytes": run["state_bytes"]})
    for rk in ranks:
        run = rk["run"]
        emit({"training_zero3_scheduled_rank": rk["rank"], "backend": rk["backend"],
              "step_ms_" + rk["backend"].replace(" ", "_"): run["step_ms"],
              "schedule": run["schedule"], "peak_memory_gib": run["peak_memory_gib"],
              "state_bytes": run["state_bytes"]})
    if not rec["ok"]:
        raise SystemExit(f"training_zero3_scheduled checks failed: {checks}")
    return rec


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_training_checkpoint() -> dict:
    """Checkpointing and its lifecycle at the training_zero phase's model
    and tokens (gas 1), world 1 over NCCL, into a temporary directory under
    ``build/`` that the phase deletes (the free disk space printed before
    it writes): engine A (the store) takes 2 steps, saves
    ``global_step2`` and verifies it, takes a third step and saves
    ``global_step3`` with the fault injector's ``checkpoint.corrupt`` set
    (the commit seals it, then bytes rot), then 2 more steps. Engine B (the
    store, other weights) loads the newest valid tag: the scan rejects
    ``global_step3`` on its checksum, quarantines it and falls back to
    ``global_step2``; B's steps 3-5 must equal A's losses and end on A's
    masters, bit for bit. Engine C (the stage-2 wire) loads
    ``global_step2`` (the reshard from 3 to 2) and its step 3 must equal
    A's. ``ds_to_universal`` writes the universal directory of
    ``global_step2`` (every parameter's master and Adam moments, step 2;
    tests/test_torch_checkpoint.py loads such directories across the
    packages). K7 once a step in every engine. Prints each save's,
    verify's and load's bytes and seconds."""
    import shutil
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.checkpoint import ds_to_universal, verify_checkpoint
    from deepspeed_tpu_torch.comm import reset_mesh_context
    from deepspeed_tpu_torch.utils.fault_injection import get_fault_injector
    build = os.path.join(ROOT, "build")
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=build)
    save_dir = os.path.join(tmp, "save")
    free_gib = shutil.disk_usage(build).free / 2**30
    emit({"training_checkpoint_free_disk_gib": free_gib, "dir": "build/"})
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store1')}",
                            rank=0, world_size=1)
    data = zero_batches()
    runs, checks, io = {}, {}, {}

    def engine_of(stage):
        return z3_run(stage, gas=1, steps=0, data=data)[0]

    def steps(engine, lo, hi, name):
        from deepspeed_tpu_torch.ops import fused_optimizer as fo
        fo.adam_step_.launches = 0
        losses = [engine.train_batch(iter([(data[i], data[i])])) for i in range(lo, hi)]
        runs[name] = {"losses": losses, "k7_launches": fo.adam_step_.launches,
                      "steps": hi - lo}
        return losses

    def timed_io(name, fn, path=None):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        io[name] = {"seconds": time.monotonic() - t}
        if path is not None:
            io[name]["bytes"] = dir_bytes(path)
        return out

    try:
        a = engine_of(3)
        steps(a, 0, 2, "A_steps_1_2")
        checks["A_saved_step2"] = timed_io(
            "save_global_step2", lambda: a.save_checkpoint(save_dir),
            os.path.join(save_dir, "global_step2"))
        checks["A_step2_verifies"] = timed_io(
            "verify_global_step2",
            lambda: verify_checkpoint(os.path.join(save_dir, "global_step2"))) == (True, "ok")
        steps(a, 2, 3, "A_step_3")
        get_fault_injector().configure({"faults": [{"site": "checkpoint.corrupt", "nth": 1}]})
        try:
            checks["A_saved_step3"] = timed_io(
                "save_global_step3", lambda: a.save_checkpoint(save_dir),
                os.path.join(save_dir, "global_step3"))
        finally:
            get_fault_injector().reset()
        steps(a, 3, 5, "A_steps_4_5")
        ref = runs["A_step_3"]["losses"] + runs["A_steps_4_5"]["losses"]
        ref_prints = master_fingerprints(a)
        del a
        free_memory()
        b = engine_of(3)
        path, _ = timed_io("load_newest_valid", lambda: b.load_checkpoint(save_dir))
        checks["B_fell_back_to_step2"] = path is not None and path.endswith("global_step2")
        checks["B_quarantined_step3"] = (not os.path.exists(os.path.join(save_dir, "global_step3"))
                                         and os.path.isdir(os.path.join(
                                             save_dir, "global_step3.quarantined")))
        shutil.rmtree(os.path.join(save_dir, "global_step3.quarantined"), ignore_errors=True)
        checks["B_resumed_losses_bit_equal"] = steps(b, 2, 5, "B_steps_3_5") == ref
        checks["B_resumed_masters_bit_equal"] = master_fingerprints(b) == ref_prints
        del b
        free_memory()
        c = engine_of(2)
        timed_io("load_into_stage2", lambda: c.load_checkpoint(save_dir, tag="global_step2"))
        checks["C_stage2_step3_bit_equal"] = steps(c, 2, 3, "C_step_3") == ref[:1]
        del c
        free_memory()
        uni = os.path.join(tmp, "universal")
        timed_io("ds_to_universal", lambda: ds_to_universal(
            os.path.join(save_dir, "global_step2"), uni), uni)
        with open(os.path.join(uni, "universal_meta.json")) as f:
            meta = json.load(f)
        checks["universal_layout_written"] = (
            meta["step"] == 2 and meta["has_optim_states"] and all(
                os.path.exists(os.path.join(uni, "zero", name, fname)) for name in meta["params"]
                for fname in ("fp32.npy", "exp_avg.npy", "exp_avg_sq.npy")))
    finally:
        dist.destroy_process_group()
        reset_mesh_context()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, run in runs.items():
        checks[f"{name}_k7_once_a_step"] = run["k7_launches"] == run["steps"]
    checks["tmp_dir_deleted"] = not os.path.exists(tmp)
    rec = {"phase": "training_checkpoint",
           "config": f"llama3_8b(num_hidden_layers={ZERO_LAYERS}, ce_chunk_size=8192), random "
           f"bf16 weights, AdamW lr {ZERO_LR} wd 0.01, the store (stage 3, fp32 wire) and the "
           f"stage-2 wire; {ZERO_ROWS} x {ZERO_SEQ} tokens a step", "gpu": gpu_identity(),
           "free_disk_gib_before": free_gib, "io": io, "runs": runs, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    for name, r in io.items():
        emit({"training_checkpoint_io": name, **r})
    if not rec["ok"]:
        raise SystemExit(f"training_checkpoint checks failed: {checks}")
    return rec


def phase_attn_sweep() -> dict:
    """The attention sweep (``ops/attn_sweep.py``) once at the Mistral
    phase's shape, into the run's fresh cache directory: each leg's K1/K2
    and K3 times and the winners it commits. Nothing after this phase
    reads them. On a card the sweep's candidates are the kernels only; the
    plain forward's time at this shape is phase 2's."""
    from deepspeed_tpu_torch.ops import attn_sweep
    from deepspeed_tpu_torch.ops import kernel_dispatch as kd
    results = attn_sweep.sweep_shape(1, MISTRAL_S, 32, 8, 128, "bfloat16", True,
                                     window=MISTRAL_WINDOW, iters=10)
    rec = {"phase": "attn_sweep", "shape": {"B": 1, "S": MISTRAL_S, "H": 32, "KV": 8,
                                            "D": 128, "causal": True,
                                            "window": MISTRAL_WINDOW},
           "winners": {leg: entry for leg, (entry, _) in results.items()},
           "rows": {leg: [list(row) for row in rows] for leg, (_, rows) in results.items()},
           "table": kd.table_source()}
    rec["ok"] = set(rec["winners"]) == {"fwd", "bwd"}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("attn_sweep committed no winner for a leg")
    return rec


SERVING_PROMPTS = [128 * (i + 1) for i in range(8)]  # prompt lengths
SERVING_NEW_TOKENS = 32
def phase_sparse_attention() -> dict:
    """SparseSelfAttention(cfg) at ``SPLASH_SHAPE`` in bf16 under the three
    default layouts at block 16, through the user's entry point: the
    forward, then ``backward()`` through autograd. With no padding mask on
    the card the call takes K8; each of its three passes must launch once
    per call (counts set to 0 just before, read just after), the forward's
    merge and dq's and dk/dv's sums once where the layout's plans split a
    group and not otherwise, and each of those in some layout. The same
    inputs through the dense path (``use_kernel=False``): o, dq, dk and dv
    of both stand beside the exact value (K8's plain versions in fp64), and
    the kernel path may be at most FLASH_EXACT_RATIO times as far off as
    the dense path, row by row, plus what the splash backward's own
    algorithm adds: it takes delta = rowsum(dO * O) from the forward's
    output rounded to bf16 (the JAX ``_splash_bwd``'s ``:253-256``, where the
    dense path's autograd sums over fp32 probabilities), and dS = P (dP -
    delta) amplifies that rounding where dP - delta cancels (BigBird's and
    Longformer's global rows, which see every key). That part is measured
    as a control: the exact backward with delta from the kernel's rounded
    o, against the exact value. The two paths' row difference is
    reported."""
    import torch
    from deepspeed_tpu_torch.ops.attention import attention_delta
    from deepspeed_tpu_torch.ops.sparse_attention import (SparseSelfAttention,
                                                          sparse_attention, splash_flops)
    from deepspeed_tpu_torch.ops.sparse_attention import splash as sp
    B, H, S, D = (SPLASH_SHAPE[k] for k in ("B", "H", "S", "D"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    kernels = {name: getattr(sp, name) for _, name, _ in SPLASH_KERNELS}
    kernels.update({name: getattr(sp, name) for _, name, _, _ in SPLASH_SECOND})
    vs = dict(floor=FLASH_EXACT_FLOOR["bfloat16"])
    runs, checks = {}, {}

    def events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    for name, config, block in SPLASH_LAYOUTS[:3]:
        cfg, layout = splash_layout(config, block)
        attn = SparseSelfAttention(cfg)
        q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        # one call to build the tables and warm up, not counted
        warm = [x.clone().requires_grad_() for x in (q, k, v)]
        attn(*warm).backward(do)
        del warm
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        out, fwd_ms = events(lambda: attn(*leaves))
        _, bwd_ms = events(lambda: out.backward(do))
        launches = {n: fn.launches for n, fn in kernels.items()}
        # each pass once a call; the merge and the sums where their plans split
        plans = sp.splash_function(layout, block, 1.0 / float(D) ** 0.5, q.device).tables
        expected = {name: 1 for _, name, _ in SPLASH_KERNELS}
        expected.update(splash_fwd_merge=int(plans.plan.n_merges > 0),
                        splash_dq_sum=int(plans.plan.n_merges > 0),
                        splash_dkdv_sum=int(plans.plan_t.n_merges > 0))
        dense = [x.clone().requires_grad_() for x in (q, k, v)]
        ref, dense_fwd_ms = events(lambda: sparse_attention(*dense, layout, block,
                                                            use_kernel=False))
        _, dense_bwd_ms = events(lambda: ref.backward(do))
        assert all(fn.launches == launches[n] for n, fn in kernels.items())
        # the exact value: K8's plain versions in fp64 on the same inputs
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        o64, lse64 = sp.splash_attention_fwd_reference(q64, k64, v64, layout, block)

        def exact_grads(delta):
            bargs = (q64, k64, v64, do64, lse64, delta, layout, block)
            return [sp.splash_attention_bwd_dq_reference(*bargs),
                    *sp.splash_attention_bwd_dkdv_reference(*bargs)]

        exact = [o64] + exact_grads(attention_delta(o64, do64))
        # the control: delta from the exact o rounded to bf16, as the
        # kernel path takes it from its bf16 o (JAX ``_splash_bwd`` :254)
        from_rounded_o = [o64] + exact_grads(
            attention_delta(o64.to(torch.bfloat16).double(), do64))
        del q64, k64, v64, do64, lse64, o64
        torch.cuda.synchronize()
        errs = {}
        for part, kx, dx, ex, rx in zip(("o", "dq", "dk", "dv"),
                                        [out.detach()] + [t.grad for t in leaves],
                                        [ref.detach()] + [t.grad for t in dense], exact,
                                        from_rounded_o):
            errs[part] = {"kernel_vs_dense_row_rel_err": row_rel_err(kx, dx, **vs),
                          "kernel_vs_exact": row_rel_err(kx, ex, **vs),
                          "dense_vs_exact": row_rel_err(dx, ex, **vs),
                          "delta_of_rounded_o_vs_exact": row_rel_err(rx, ex, **vs),
                          "finite": bool(torch.isfinite(kx.float()).all())}
        del exact, from_rounded_o, out, ref, leaves, dense
        free_memory()
        runs[name] = {"block": block, "layout": config, "launches": launches,
                      "expected_launches": expected,
                      "plan": {"fwd": splash_plan_record(plans.plan),
                               "dkdv": splash_plan_record(plans.plan_t)},
                      "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "dense_fwd_ms": dense_fwd_ms,
                      "dense_bwd_ms": dense_bwd_ms,
                      "splash_flops": splash_flops(layout, block, D, batch=B), "errors": errs}
        checks[f"{name}_each_kernel_launched_as_planned"] = launches == expected
        checks[f"{name}_kernel_path_matches_dense_path"] = all(
            e["finite"] and e["kernel_vs_exact"] <= FLASH_EXACT_RATIO * e["dense_vs_exact"]
            + e["delta_of_rounded_o_vs_exact"] for e in errs.values())
    for _, name, _, _ in SPLASH_SECOND:
        checks[f"{name}_launched"] = any(r["launches"][name] for r in runs.values())
    rec = {"phase": "sparse_attention", "gpu": gpu_identity(),
           "config": f"SparseSelfAttention(cfg), B {B}, H {H}, S {S}, D {D}, bf16; "
                     "forward, then backward() through autograd",
           "tolerance": "row by row against the exact fp64 value, the kernel path at most "
                        f"{FLASH_EXACT_RATIO}x the dense path's error plus the exact "
                        "backward's own error with delta from the exact o rounded to bf16",
           "runs": runs, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"sparse attention checks failed: {checks}")
    return rec


SERVING_KV_BYTES = 8 << 30  # the KV budget of the serving phases
SC2_PROMPTS = [5120, 4608, 2048, 1024, 512, 256, 128, 128]
SC2_NEW_TOKENS = 64
# the bf16 engine against the plain fp32 forward on the 5120-token prompt:
# 32 layers round the residual stream, each projection's output and K/V to
# bf16 (2^-9 relative each). On an H100 the engine read 1 - cos = 1.2e-4;
# the plain forward without the window read 8.8e-3 and without the biases
# 0.133 against the sound one. The limit, 1e-3, sits between the engine and
# the window control, ~8x from each; every run reads both controls again
# and fails if either is within the limit.
SC2_COSINE = 0.999
# the window's stream comparison: each prompt cut to WAVE_PROMPT tokens, 8 x
# 96 = 768 (the batch budget), so one put admits all eight and every decode
# step batches the same sequences at windows 16 and 1; a sampled run on the
# bf16 engine with SAMPLED_KW, its logprobs within SAMPLED_LP_TOL
WAVE_PROMPT = 96
SAMPLED_KW = dict(temperature=0.8, top_k=50, top_p=0.9, return_logprobs=True)
SAMPLED_LP_TOL = 1e-5


def _drive_serving(counters: dict, cfg=None, prompt_lens=SERVING_PROMPTS,
                   new_tokens: int = SERVING_NEW_TOKENS, make_params=None,
                   check_prompt: int = 2, on_put=None, inspect=None,
                   norms_per_forward: dict = None, sampled: bool = False,
                   **build_kw) -> dict:
    """build_llama_engine at the full width of ``cfg`` (default
    Llama-3-8B; 32 layers, seeded random bf16 weights, or the model
    ``make_params()`` returns, 64-token KV blocks filling
    ``SERVING_KV_BYTES``), then greedy ``generate`` on prompts of
    ``prompt_lens`` tokens with the fused decode window at its default
    (16). Each count of ``counters`` (name -> (wrapper, attribute)) is set
    to 0 just before the build and read after it and after ``generate``;
    K4's launches by kernel are read around each per-step forward (L of
    the wgmma tiles in every prefill forward, L of the decode kernel in
    every per-step decode forward) and around each window
    (``fused_decode_steps``: K·L of the decode kernel and, for each name
    of ``norms_per_forward``, K times its count, nothing else of K4).
    ``forwards`` counts every ragged forward, a window's steps included.
    Records each forward's and window's time and each prompt's prefill
    logits (the last ``put`` that fed it more than one token), calls
    ``on_put(engine, uids)`` after every ``put``, then checks prefill
    against decode on prompt ``check_prompt`` (fed in chunks of the batch
    budget; a model with a final softcap leaves that check to the caller,
    which gets both logits as ``check_logits``) and hands the engine to
    ``inspect(engine, prompts, prefill_logits)``, whose (record, checks)
    join the phase's. Then ``window_runs``: the same prompts at window 1,
    and the prompts cut to one admission wave (WAVE_PROMPT tokens each, so
    that every step batches the same sequences at either window) at
    windows 16 and 1, whose greedy streams must be equal (with ``sampled``
    also a sampled run, SAMPLED_KW, equal tokens and logprobs within
    SAMPLED_LP_TOL); each run's decode tokens/s on generate's wall time."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2.config_v2 import (KVCacheConfig,
                                                            RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import per_token_kv_bytes
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.paged_attention import KERNEL_COUNTERS, paged_attention

    cfg = cfg or LlamaConfig.llama3_8b()
    norms_per_forward = norms_per_forward or {}
    per_block = 64 * per_token_kv_bytes(KVCacheConfig(
        block_size=64, cache_shape=(cfg.num_hidden_layers, cfg.num_key_value_heads,
                                    cfg.head_dim_),
        cache_dtype=build_kw.get("kv_cache_dtype") or "bfloat16"))
    num_blocks = SERVING_KV_BYTES // per_block
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    before_build = torch.cuda.memory_allocated()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.monotonic()
    engine = build_llama_engine(
        cfg, params=make_params() if make_params else None,
        engine_config=RaggedInferenceEngineConfig(num_kv_blocks=num_blocks),
        seed=0, dtype=torch.bfloat16, kv_block_size=64, **build_kw)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    at_build = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    built_bytes = torch.cuda.memory_allocated() - before_build
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    model = engine.model()
    inner_forward, inner_put = model.forward, engine.put
    inner_fused = engine.fused_decode_steps
    # per-step forwards: (real tokens, decode?, seconds, K4 launches by
    # kernel in K4_KINDS' order); windows: (K, sequences, seconds, K4
    # launches by kernel, {norm name: launches})
    steps, windows = [], []
    bad_logits = []
    prefill_logits = {}

    def k4_counts():
        return tuple(getattr(paged_attention, c) for c in KERNEL_COUNTERS)

    def norm_counts():
        return {n: getattr(*counters[n]) for n in norms_per_forward}

    def counted_forward(batch, **kw):
        torch.cuda.synchronize()
        before = k4_counts()
        t = time.monotonic()
        logits = inner_forward(batch, **kw)
        torch.cuda.synchronize()
        steps.append((batch.n_tokens, batch.q_tok_idx.shape[1] == 1, time.monotonic() - t,
                      tuple(a - b for a, b in zip(k4_counts(), before))))
        if logits.shape != (batch.seq_start.shape[0], cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            bad_logits.append(len(steps))
        return logits

    def counted_fused(uids, last_tokens, n_steps, specs=None):
        torch.cuda.synchronize()
        before, norms = k4_counts(), norm_counts()
        t = time.monotonic()
        out = inner_fused(uids, last_tokens, n_steps, specs=specs)
        torch.cuda.synchronize()  # the harvest fetched already
        windows.append((n_steps, len(uids), time.monotonic() - t,
                        tuple(a - b for a, b in zip(k4_counts(), before)),
                        {n: c - norms[n] for n, c in norm_counts().items()}))
        toks = out if specs is None else out[0]
        if toks.shape != (len(uids), n_steps) or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
            bad_logits.append(("window", len(windows)))
        return out

    def recording_put(uids, tokens, do_checks=True, **kw):
        logits = inner_put(uids, tokens, do_checks=do_checks, **kw)
        for i, (u, t) in enumerate(zip(uids, tokens)):
            if len(t) > 1:
                prefill_logits[u] = logits[i].float().cpu()
        if on_put:
            on_put(engine, uids)
        return logits

    model.forward, engine.put = counted_forward, recording_put
    engine.fused_decode_steps = counted_fused
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    t0 = time.monotonic()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    gen_s = time.monotonic() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    main_windows, main_steps = list(windows), list(steps)
    main_prefill = dict(prefill_logits)  # the later runs' prefills are others
    peak = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_hidden_layers

    def summary(outs_, seconds, steps_, windows_):
        """A generate's decode tokens/s on its wall time less its prefill
        forwards', and the per-step and window steps' ms."""
        prefill_s = sum(s for _, dec, s, _ in steps_ if not dec)
        dec = [s for _, d, s, _ in steps_ if d]
        n_decode = sum(len(o) for o in outs_) - len(outs_)  # the first come from prefill
        w_steps = sum(k for k, *_ in windows_)
        return {"generate_s": seconds, "prefill_forward_s": prefill_s,
                "decode_tokens": n_decode,
                "decode_tokens_per_s": n_decode / (seconds - prefill_s),
                "per_step_decode_forwards": len(dec),
                "per_step_decode_ms_mean": 1e3 * sum(dec) / len(dec) if dec else None,
                "windows": [[k, n] for k, n, *_ in windows_], "window_steps": w_steps,
                "window_ms_per_step": (1e3 * sum(s for _, _, s, *_ in windows_) / w_steps
                                       if w_steps else None)}

    def run_generate(prompts_, window, **kw):
        steps.clear()
        windows.clear()
        torch.cuda.synchronize()
        t = time.monotonic()
        out = engine.generate(prompts_, max_new_tokens=new_tokens, fused_decode_window=window,
                              **kw)
        torch.cuda.synchronize()
        toks = out[0] if kw.get("return_logprobs") else out
        return out, summary(toks, time.monotonic() - t, steps, windows), list(windows)

    # the window's launch rule in every window of every run
    window_checks = []

    def window_rule(windows_):
        dec_i = K4_KINDS.index("decode")
        return all(k4[dec_i] == k * L and sum(k4) == k * L
                   and all(norms[n] == k * c for n, c in norms_per_forward.items())
                   for k, _, _, k4, norms in windows_)

    window_checks.append(window_rule(main_windows))
    runs = {"staggered_k16": summary(outs, gen_s, main_steps, main_windows)}
    _, runs["staggered_k1"], w = run_generate(prompts, 1)
    window_checks.append(not w)
    wave = [p[:WAVE_PROMPT] for p in prompts]
    g16, runs["one_wave_k16"], w = run_generate(wave, 16)
    window_checks.append(window_rule(w) and len(w) > 0)
    g1, runs["one_wave_k1"], _ = run_generate(wave, 1)
    stream_checks = {"one_wave_greedy_streams_k16_equal_k1": g16 == g1}
    if sampled:
        s16, runs["one_wave_sampled_k16"], w = run_generate(wave, 16, **SAMPLED_KW)
        window_checks.append(window_rule(w) and len(w) > 0)
        s1, runs["one_wave_sampled_k1"], _ = run_generate(wave, 1, **SAMPLED_KW)
        lp_diff = max(abs(a - b) for x, y in zip(s16[1], s1[1]) for a, b in zip(x, y))
        runs["one_wave_sampled_logprob_max_abs_diff"] = lp_diff
        stream_checks["one_wave_sampled_tokens_k16_equal_k1"] = s16[0] == s1[0]
        stream_checks["one_wave_sampled_logprobs_k16_within_tol_of_k1"] = \
            len(s16[0]) == len(s1[0]) and lp_diff <= SAMPLED_LP_TOL
    model.forward, engine.put = inner_forward, inner_put
    del engine.fused_decode_steps
    runs["graphs"] = len(model._graphs)
    runs["graph_pool_bytes"] = model.graph_pool_bytes
    runs["graph_capture_s"] = model.graph_capture_s  # host time of the captures
    free_after = engine.free_blocks

    # prefill vs decode: the same last-token logits either way
    full, step = prefill_and_decode(engine, 1000, prompts[check_prompt])
    diff = (full - step).abs().max().item()
    # bf16 activations: 32 layers round the residual stream to bf16 (2^-9
    # relative) on two different reduction orders; allow 5% of max|logit|.
    # A final softcap bounds max|logit| whatever the spread before it: the
    # caller holds such a model's two against the logits before the cap
    capped = bool(cfg.final_logit_softcapping)
    consistency_tol = None if capped else 0.05 * full.abs().max().item()

    pre = [(n, s) for n, dec, s, _ in main_steps if not dec]
    dec = [(n, s) for n, dec, s, _ in main_steps if dec]
    # K4's wgmma tiles: L launches in every prefill forward, none in decode;
    # its decode kernel L in every decode forward; the CUDA-core kernel and
    # the fp32-query kernels none in either
    per_fwd = {kind: {"prefill": [k[i] for _, dec, _, k in main_steps if not dec],
                      "decode": [k[i] for _, dec, _, k in main_steps if dec]}
               for i, kind in enumerate(K4_KINDS)}
    wgmma = per_fwd["wgmma"]
    window_steps = sum(k for k, *_ in main_windows)
    # the launches of each K4 kernel: per-step forwards and windows
    k4_total = {kind: sum(map(sum, v.values())) + sum(w[3][i] for w in main_windows)
                for i, (kind, v) in enumerate(per_fwd.items())}
    rec = {"gpu": gpu_identity(), "engine_build_s": build_s,
           "prompt_lens": list(prompt_lens), "new_tokens": new_tokens,
           "kv_blocks": num_blocks, "kv_bytes_per_block": per_block,
           "layer_weight_bytes": model.layer_weight_bytes(),
           "memory_after_build_gib": built_bytes / 2**30,
           "build_peak_memory_gib": build_peak,
           "generate_s": gen_s, "forwards": len(main_steps) + window_steps,
           "prefill_forwards": len(pre), "decode_forwards": len(dec) + window_steps,
           "per_step_decode_forwards": len(dec), "window_steps": window_steps,
           "launches_at_build": at_build,
           "launches": {**launches,
                        **{"paged_attention_" + kind: n for kind, n in k4_total.items()}},
           **{f"paged_attention_{kind}_per_forward": {k: sorted(set(n)) for k, n in v.items()}
              for kind, v in per_fwd.items()},
           "prefill_tokens_per_s": sum(n for n, _ in pre) / sum(s for _, s in pre),
           "per_step_decode_tokens_per_s": (sum(n for n, _ in dec) / sum(s for _, s in dec)
                                            if dec else None),
           "per_step_decode_ms_mean": 1e3 * sum(s for _, s in dec) / len(dec) if dec else None,
           "window_runs": runs,
           "peak_memory_gib": peak,
           "prefill_decode_max_abs_diff": diff,
           "prefill_decode_tolerance": consistency_tol}
    checks = {
        "outputs_all_new_tokens_valid_ids": len(outs) == len(prompts) and all(
            len(o) == new_tokens and all(0 <= t < cfg.vocab_size for t in o)
            for o in outs),
        "logits_finite": not bad_logits,
        "prefill_logits_of_every_prompt":
            sorted(main_prefill) == list(range(len(prompts))),
        "free_blocks_back_to_total": free_after == num_blocks,
        "paged_attention_wgmma_L_per_prefill_forward": all(w == L for w in wgmma["prefill"]),
        "paged_attention_wgmma_none_in_decode": not any(wgmma["decode"]),
        "paged_attention_decode_L_per_decode_forward":
            all(d == L for d in per_fwd["decode"]["decode"]),
        "paged_attention_no_cuda_core_launch": not any(
            per_fwd["cuda_cores"]["prefill"] + per_fwd["cuda_cores"]["decode"]),
        "paged_attention_no_fp32_kernel_launch": not any(
            sum(per_fwd[k]["prefill"] + per_fwd[k]["decode"]) for k in ("f32_chunk",
                                                                        "f32_decode")),
        "windows_ran_at_default_16": max((k for k, *_ in main_windows), default=0) == 16,
        "window_k4_decode_KL_norms_K_per_forward_nothing_else": all(window_checks),
        **stream_checks,
    }
    if not capped:
        checks["prefill_decode_consistent"] = diff <= consistency_tol
    if inspect:
        more_rec, more_checks = inspect(engine, prompts, main_prefill)
        rec.update(more_rec)
        checks.update(more_checks)
    del engine, model
    free_memory()
    return {"rec": rec, "checks": checks, "prefill_logits": main_prefill,
            "layers": cfg.num_hidden_layers, "prompts": prompts,
            "check_logits": (full.cpu(), step.cpu())}


# K4's kernels as the serving records name them ("paged_attention_" +
# kind), in the order of paged_attention's KERNELS and KERNEL_COUNTERS
K4_KINDS = ("cuda_cores", "wgmma", "decode", "f32_chunk", "f32_decode")


def count_k4_kernels(kernels: list, phase: str, rec: dict) -> None:
    """Adds a serving phase's launches of K4's wgmma tiles and decode
    kernel to their entries."""
    for k in kernels:
        if k["name"] in ("paged_attention_wgmma", "paged_attention_decode"):
            k.setdefault("launches_by_phase", {})[phase] = rec["launches"][k["name"]]
            k["launches"] = sum(k["launches_by_phase"].values())


def phase_serving(kernels: list) -> dict:
    """The bf16 engine: K4 once and K5 2L+1 times per forward."""
    from deepspeed_tpu_torch.ops.normalization import rms_norm
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    L = LlamaConfig.llama3_8b().num_hidden_layers
    run = _drive_serving({"paged_attention": (paged_attention, "launches"),
                          "rms_norm": (rms_norm, "launches")},
                         norms_per_forward={"rms_norm": 2 * L + 1}, sampled=True)
    rec, checks, L = run["rec"], run["checks"], run["layers"]
    n_fwd, launches = rec["forwards"], rec["launches"]
    checks["paged_attention_launches_per_forward"] = launches["paged_attention"] == L * n_fwd
    checks["rms_norm_launches_per_forward"] = launches["rms_norm"] == (2 * L + 1) * n_fwd
    rec = {"phase": "serving", "config": "llama3_8b (32 layers, random bf16 weights)",
           **rec, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"serving checks failed: {checks}")
    for k in kernels:
        if k["name"] in launches and k["name"] not in {"paged_attention_" + kind
                                                       for kind in K4_KINDS}:
            k["launches"] = launches[k["name"]]
    count_k4_kernels(kernels, "serving", rec)
    return {"rec": rec, "prefill_logits": run["prefill_logits"]}


def k6_build_total(built: list) -> dict:
    """K6's device time over an engine build: each distinct (shape, dtype,
    block) of ``built`` graph-timed once on fresh N(0, 0.02) values, times
    its launches; beside it the bound of the same launches."""
    import collections
    import torch
    from deepspeed_tpu_torch.ops.quantizer import quantize_int8_blockwise
    shapes, total, bound = [], 0.0, 0.0
    for (shape, dtype, block), count in collections.Counter(built).items():
        x = (0.02 * torch.randn(*shape, device="cuda")).to(dtype)
        ms = graph_time_ms(lambda: quantize_int8_blockwise(x, block))
        n = x.numel()
        rows = -(-n // block)
        b = (n * x.element_size() + rows * block + rows * 4) / HBM_BYTES_PER_S * 1e3
        shapes.append({"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                       "block": block, "launches": count, "ms": ms, "bound_ms": b})
        total, bound = total + count * ms, bound + count * b
        del x
    free_memory()
    return {"timing": "cuda graph, each shape once", "launches": len(built),
            "total_ms": total, "bound_ms": bound, "shapes": shapes}


def phase_serving_int8(kernels: list, bf16: dict) -> dict:
    """The same weights, prompts and KV bytes with int8 weights (K6 7 times
    per layer at build, the dequantize helper at each of the 7L uses per
    forward) and an int8 KV cache (K4's int8 instance once per layer)."""
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.normalization import rms_norm
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    from deepspeed_tpu_torch.ops.quantizer import (dequantize_int8_blockwise,
                                                   quantize_int8_blockwise)
    counters = {"paged_attention_int8": (paged_attention, "int8_launches"),
                "paged_attention": (paged_attention, "launches"),
                "rms_norm": (rms_norm, "launches"),
                "quantize_int8_blockwise": (quantize_int8_blockwise, "launches"),
                "dequantize_int8_blockwise": (dequantize_int8_blockwise, "launches")}
    from deepspeed_tpu_torch.linear import quantization as lq
    built = []  # K6's inputs at build: (shape, dtype, block)

    def recording_quantize(w, block_size=2048):
        built.append((tuple(w.shape), w.dtype, block_size))
        return quantize_int8_blockwise(w, block_size)
    lq.quantize_int8_blockwise = recording_quantize
    try:
        L = LlamaConfig.llama3_8b().num_hidden_layers
        run = _drive_serving(counters, quantize="int8", kv_cache_dtype="int8",
                             norms_per_forward={"rms_norm": 2 * L + 1,
                                                "dequantize_int8_blockwise": 7 * L})
    finally:
        lq.quantize_int8_blockwise = quantize_int8_blockwise
    rec, checks, L = run["rec"], run["checks"], run["layers"]
    rec["k6_at_build"] = k6_build_total(built)
    n_fwd, launches, at_build = rec["forwards"], rec["launches"], rec["launches_at_build"]
    # each prompt's prefill logits against the bf16 engine's: the int8
    # weights and KV move each logit by the quantization noise only
    cosines = [torch.nn.functional.cosine_similarity(
        run["prefill_logits"][u], bf16["prefill_logits"][u], dim=0).item()
        for u in range(8)]
    memory_saved = bf16["rec"]["memory_after_build_gib"] - rec["memory_after_build_gib"]
    checks.update({
        "quantize_launches_7L_at_build": at_build["quantize_int8_blockwise"] == 7 * L
        and launches["quantize_int8_blockwise"] == 7 * L,
        # k6_at_build saw every launch the counter saw
        "k6_at_build_every_launch": len(built) == at_build["quantize_int8_blockwise"],
        "dequantize_launches_7L_per_forward":
            launches["dequantize_int8_blockwise"] == 7 * L * n_fwd,
        "paged_attention_int8_launches_per_forward":
            launches["paged_attention_int8"] == L * n_fwd and launches["paged_attention"] == 0,
        "rms_norm_launches_per_forward": launches["rms_norm"] == (2 * L + 1) * n_fwd,
        "memory_after_build_6gib_below_bf16": memory_saved >= 6.0,
        "prefill_logits_cosine_vs_bf16": min(cosines) >= 0.99,
    })
    rec = {"phase": "serving_int8",
           "config": 'llama3_8b (32 layers, random bf16 weights), quantize="int8", '
                     'kv_cache_dtype="int8"',
           **rec, "memory_saved_vs_bf16_gib": memory_saved,
           "prefill_logits_cosine_vs_bf16": cosines, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"int8 serving checks failed: {checks}")
    for k in kernels:
        if k["name"] in launches and k["name"] not in ("paged_attention", "rms_norm",
                                                       "paged_attention_wgmma",
                                                       "paged_attention_decode"):
            k["launches"] = launches[k["name"]]
    count_k4_kernels(kernels, "serving_int8", rec)
    return rec


def plain_forward_fp32(model, cfg, tokens: list, q_block: int = 1024,
                       window: bool = True, biases: bool = True, alibi: bool = True,
                       embed_ln: bool = True):
    """The last token's logits of ``tokens`` from a plain fp32 forward of
    a StarCoder2- or BLOOM-form ``model`` (LayerNorm with bias, biased
    projections, the gelu-tanh fc MLP, tied embeddings; StarCoder2's rope
    and sliding window on every layer, or BLOOM's ALiBi and embedding
    LayerNorm): every weight cast to fp32 where it is used, no KV cache
    and no kernel of the port; each block of ``q_block`` queries attends
    over the whole sequence under a dense causal (+ window) mask. The
    controls: ``window=False`` attends to every earlier key,
    ``biases=False`` leaves out the projections' biases, ``alibi=False``
    the ALiBi bias and ``embed_ln=False`` the embedding LayerNorm."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models.llama import alibi_slopes
    assert cfg.norm_type == "layernorm" and cfg.mlp_type == "gelu_tanh_fc" and \
        cfg.tie_word_embeddings and cfg.sliding_window_layers is None
    dev = model.embed_tokens.weight.device
    T = len(tokens)
    W = cfg.sliding_window if window and cfg.sliding_window else T
    use_alibi = cfg.pos_embedding == "alibi"
    hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    pos = torch.arange(T, device=dev)
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, device=dev,
                                                      dtype=torch.float32) / hd))
    ang = pos.float()[:, None] * inv_freq[None, :]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]

    def norm(x, mod):
        xc = x - x.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + cfg.rms_norm_eps) * mod.scale.float() + mod.bias.float()

    def lin(x, dense):
        y = x @ dense.kernel.float()
        return y + dense.bias.float() if biases else y

    def rope(x):
        x1, x2 = x.chunk(2, -1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    slopes = torch.from_numpy(alibi_slopes(nq)).to(dev)[:, None, None]  # [H, 1, 1]
    x = model.embed_tokens.weight[torch.tensor(tokens, device=dev)].float()
    if cfg.embed_layernorm and embed_ln:
        x = norm(x, model.embed_layernorm)
    for layer in model.layers:
        a = layer.self_attn
        h = norm(x, layer.input_layernorm)
        q = lin(h, a.q_proj).view(T, nq, hd)
        # query head j reads KV head j // G (the kv-major head order)
        k = lin(h, a.k_proj).view(T, nkv, hd)
        if not use_alibi:
            q, k = rope(q), rope(k)
        k = k.repeat_interleave(nq // nkv, 1)
        v = lin(h, a.v_proj).view(T, nkv, hd).repeat_interleave(nq // nkv, 1)
        ctx = torch.empty(T, nq, hd, device=dev)
        for q0 in range(0, T, q_block):
            qp = pos[q0:q0 + q_block, None]
            scores = torch.einsum("qhd,khd->hqk", q[q0:q0 + q_block], k) * hd ** -0.5
            if use_alibi and alibi:
                scores = scores + slopes * (pos[None, :] - qp).float()
            keep = (pos[None, :] <= qp) & (pos[None, :] > qp - W)
            probs = scores.masked_fill(~keep, float("-inf")).softmax(-1)
            ctx[q0:q0 + q_block] = torch.einsum("hqk,khd->qhd", probs, v)
        x = x + lin(ctx.reshape(T, nq * hd), a.o_proj)
        m = layer.mlp
        x = x + lin(F.gelu(lin(norm(x, layer.post_attention_layernorm), m.fc1),
                           approximate="tanh"), m.fc2)
    x = norm(x[-1:], model.norm)
    return (x @ model.embed_tokens.weight.float().T)[0]


def phase_serving_starcoder2(kernels: list) -> dict:
    """StarCoder2-7B through the user's entry points: the published config
    through ``policy_for("starcoder2").config_from_hf``, a seeded random
    bf16 ``LlamaModel`` (biases and LayerNorm parameters off their zero /
    one initial values, so they count), ``build_llama_engine``,
    ``generate``. K5b 2L+1 and K4 (windowed) L times per forward; the
    trailing-window release after every put."""
    import torch
    from deepspeed_tpu_torch.models.llama import init_llama
    from deepspeed_tpu_torch.module_inject import STARCODER2_7B, policy_for
    from deepspeed_tpu_torch.ops.normalization import layer_norm, rms_norm
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention

    cfg = policy_for("starcoder2").config_from_hf(STARCODER2_7B)
    W, bs = cfg.sliding_window, 64

    def make_params():
        model = init_llama(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".bias") or name.endswith(".scale"):
                    noise = torch.randn(p.shape, generator=gen, device="cuda")
                    p.copy_(0.02 * noise if name.endswith(".bias") else 1 + 0.1 * noise)
        return model

    blocks = {"wrong": [], "max_live": {}}

    def on_put(engine, uids):
        """Live blocks of each sequence = allocated less the blocks wholly
        below the next query's window (the JAX engine's rule)."""
        for u in uids:
            seq = engine._state_manager.get_sequence(u)
            if seq is None:
                continue
            live = len(seq.kv_blocks)
            want = seq.cur_allocated_blocks - max(0, (seq.seen_tokens - (W - 1)) // bs)
            if live != want:
                blocks["wrong"].append([u, seq.seen_tokens, live, want])
            blocks["max_live"][u] = max(blocks["max_live"].get(u, 0), live)

    def inspect(engine, prompts, prefill_logits):
        model = engine.model().model
        got = prefill_logits[0].cuda()

        def cosine(a, b):
            return torch.nn.functional.cosine_similarity(a, b, dim=0).item()

        t = time.monotonic()
        with torch.no_grad():
            ref = plain_forward_fp32(model, cfg, prompts[0])
        torch.cuda.synchronize()
        forward_s = time.monotonic() - t
        # controls: what the cosine reads when the forward leaves out the
        # window or the biases, against the sound plain forward
        controls = {}
        for name, kw in (("no_window", {"window": False}), ("no_biases", {"biases": False})):
            with torch.no_grad():
                ctl = plain_forward_fp32(model, cfg, prompts[0], **kw)
            controls[name] = {"cosine_vs_plain_fp32": cosine(ctl, ref),
                              "cosine_vs_engine": cosine(ctl, got)}
        cos = cosine(got, ref)
        rec = {"plain_fp32_forward_s": forward_s,
               "prefill_logits_cosine_vs_plain_fp32": cos,
               "plain_fp32_prompt_tokens": len(prompts[0]),
               "prefill_vs_plain_max_abs_diff": (got - ref).abs().max().item(),
               "cosine_controls": controls}
        return rec, {"prefill_logits_cosine_vs_plain_fp32": cos >= SC2_COSINE,
                     "cosine_controls_outside_the_limit": all(
                         c["cosine_vs_plain_fp32"] < SC2_COSINE for c in controls.values())}

    counters = {"layer_norm": (layer_norm, "launches"),
                "paged_attention": (paged_attention, "launches"),
                "paged_attention_int8": (paged_attention, "int8_launches"),
                "rms_norm": (rms_norm, "launches")}
    run = _drive_serving(counters, cfg=cfg, prompt_lens=SC2_PROMPTS,
                         new_tokens=SC2_NEW_TOKENS, make_params=make_params,
                         check_prompt=1, on_put=on_put, inspect=inspect,
                         norms_per_forward={"layer_norm": 2 * cfg.num_hidden_layers + 1})
    rec, checks, L = run["rec"], run["checks"], run["layers"]
    n_fwd, launches = rec["forwards"], rec["launches"]
    max_live = blocks["max_live"]
    checks.update({
        "layer_norm_launches_per_forward": launches["layer_norm"] == (2 * L + 1) * n_fwd,
        "paged_attention_launches_per_forward":
            launches["paged_attention"] == L * n_fwd,
        "no_rms_norm_or_int8_cache": launches["rms_norm"] == 0
        and launches["paged_attention_int8"] == 0,
        "live_blocks_follow_the_window": not blocks["wrong"],
        "longest_prompt_at_most_65_live_blocks": 0 < max_live[0] <= W // bs + 1,
    })
    rec = {"phase": "serving_starcoder2",
           "config": "STARCODER2_7B via policy_for('starcoder2').config_from_hf "
                     "(32 layers, hidden 4608, 36/4 heads, window 4096, tied "
                     "embeddings; random bf16 weights)",
           **rec, "max_live_blocks": [max_live[u] for u in sorted(max_live) if u < 8],
           "live_block_mismatches": blocks["wrong"][:8],
           "cosine_tolerance": SC2_COSINE, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"StarCoder2 serving checks failed: {checks}")
    for k in kernels:
        if k["name"] == "layer_norm":
            k["launches"] = launches["layer_norm"]
            k["launches_by_phase"] = {"serving_starcoder2": launches["layer_norm"]}
        elif k["name"] == "paged_attention_window":
            k["launches"] = launches["paged_attention"]
    count_k4_kernels(kernels, "serving_starcoder2", rec)
    return rec


# BLOOM-7B1: 8 prompts of 128..2048 tokens (the model's trained length), 32
# new tokens each, in the phases' 8 GiB KV budget (273 blocks of 64 tokens
# at 480 KiB per token)
BLOOM_PROMPTS = [2048, 1536, 1024, 1024, 512, 256, 128, 128]
BLOOM_NEW_TOKENS = 32
# the bf16 engine against the plain fp32 forward on the 2048-token prompt,
# as phase 8's StarCoder2 limit (30 layers rounding to bf16); every run
# reads three controls, the plain forward without ALiBi, without the
# biases and without the embedding LayerNorm, and fails if any is within
# the limit
BLOOM_COSINE = 0.999


def phase_serving_bloom(kernels: list) -> dict:
    """BLOOM-7B1 through the user's entry points: the published config
    through ``policy_for("bloom").config_from_hf(BLOOM_7B1)``, a seeded
    random bf16 ``LlamaModel`` (biases and LayerNorm parameters off their
    zero / one initial values, so they count), ``build_llama_engine``,
    ``generate``, at full width and depth. K4's ALiBi instance L times and
    K5b 2L+2 times per forward (the embedding LayerNorm included)."""
    import torch
    from deepspeed_tpu_torch.models.llama import init_llama
    from deepspeed_tpu_torch.module_inject import BLOOM_7B1, policy_for
    from deepspeed_tpu_torch.ops.normalization import layer_norm, rms_norm
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention

    cfg = policy_for("bloom").config_from_hf(BLOOM_7B1)

    def make_params():
        model = init_llama(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".bias") or name.endswith(".scale"):
                    noise = torch.randn(p.shape, generator=gen, device="cuda")
                    p.copy_(0.02 * noise if name.endswith(".bias") else 1 + 0.1 * noise)
        return model

    def inspect(engine, prompts, prefill_logits):
        model = engine.model().model
        got = prefill_logits[0].cuda()

        def cosine(a, b):
            return torch.nn.functional.cosine_similarity(a, b, dim=0).item()

        t = time.monotonic()
        with torch.no_grad():
            ref = plain_forward_fp32(model, cfg, prompts[0])
        torch.cuda.synchronize()
        forward_s = time.monotonic() - t
        controls = {}
        for name, kw in (("no_alibi", {"alibi": False}), ("no_biases", {"biases": False}),
                         ("no_embed_ln", {"embed_ln": False})):
            with torch.no_grad():
                ctl = plain_forward_fp32(model, cfg, prompts[0], **kw)
            controls[name] = {"cosine_vs_plain_fp32": cosine(ctl, ref),
                              "cosine_vs_engine": cosine(ctl, got)}
        cos = cosine(got, ref)
        n_params = sum(p.numel() for p in model.parameters())
        rec = {"plain_fp32_forward_s": forward_s, "parameters": n_params,
               "prefill_logits_cosine_vs_plain_fp32": cos,
               "plain_fp32_prompt_tokens": len(prompts[0]),
               "prefill_vs_plain_max_abs_diff": (got - ref).abs().max().item(),
               "cosine_controls": controls}
        return rec, {"prefill_logits_cosine_vs_plain_fp32": cos >= BLOOM_COSINE,
                     "cosine_controls_outside_the_limit": all(
                         c["cosine_vs_plain_fp32"] < BLOOM_COSINE for c in controls.values())}

    counters = {"layer_norm": (layer_norm, "launches"),
                "paged_attention_alibi": (paged_attention, "alibi_launches"),
                "paged_attention": (paged_attention, "launches"),
                "paged_attention_int8": (paged_attention, "int8_launches"),
                "rms_norm": (rms_norm, "launches")}
    run = _drive_serving(counters, cfg=cfg, prompt_lens=BLOOM_PROMPTS,
                         new_tokens=BLOOM_NEW_TOKENS, make_params=make_params,
                         norms_per_forward={"layer_norm": 2 * cfg.num_hidden_layers + 2},
                         check_prompt=1, inspect=inspect)
    rec, checks, L = run["rec"], run["checks"], run["layers"]
    n_fwd, launches = rec["forwards"], rec["launches"]
    checks.update({
        "paged_attention_alibi_launches_per_forward":
            launches["paged_attention_alibi"] == L * n_fwd,
        "layer_norm_launches_per_forward": launches["layer_norm"] == (2 * L + 2) * n_fwd,
        "no_other_k4_instance_or_rms_norm": launches["paged_attention"] == 0
        and launches["paged_attention_int8"] == 0 and launches["rms_norm"] == 0,
    })
    rec = {"phase": "serving_bloom",
           "config": "BLOOM_7B1 via policy_for('bloom').config_from_hf (30 layers, hidden "
                     "4096, 32 heads, MHA, ALiBi, embedding LayerNorm, vocab 250880, tied "
                     "embeddings; random bf16 weights)",
           **rec, "cosine_tolerance": BLOOM_COSINE, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"BLOOM serving checks failed: {checks}")
    for k in kernels:
        if k["name"] == "paged_attention_alibi":
            k["launches"] = launches["paged_attention_alibi"]
        elif k["name"] == "layer_norm":
            k["launches_by_phase"]["serving_bloom"] = launches["layer_norm"]
            k["launches"] = sum(k["launches_by_phase"].values())
    count_k4_kernels(kernels, "serving_bloom", rec)
    return rec


# serving_speculative: the prefix cache, speculative decoding and score at
# the Llama-3-8B width
SPEC_PREFIX = 2048                      # the shared prefix of part (a)
SPEC_TAILS = [64, 200, 88, 176, 112, 152, 136, 100]  # its eight distinct tails
SPEC_FORK_AT = 30                       # the last prompt shares 30 tail tokens
SPEC_PATTERN, SPEC_PROMPT, SPEC_NEW = 64, 512, 64  # part (b)
SPEC_DRAFTS, SPEC_NGRAM = 4, 2
# the sampled pair drafts 3: its windows feed 1 + 3 = 4 tokens, a power of
# two, so that the per-token verify (N bucketed to 4) and the fused window
# (N 4) batch the same shapes and give the same logits
SPEC_SAMPLED_DRAFTS = 3
SPEC_SAMPLED_KW = dict(temperature=0.8, top_p=0.95, seed=0)
# a greedy divergence between two paths is explained where the logit
# margin of the two tokens there is within this many times the measured
# difference of the two paths' logits at that position
SPEC_MARGIN_RATIO = 2.0


def spec_divergence(engine, prompt: list, a: list, b: list, drafts: int) -> dict:
    """The first index where streams ``a`` and ``b`` of ``prompt`` differ
    (None when they are equal), and there the logits of the next token by
    the two kinds of forward that serve it: a one-token decode put and a
    verify window of ``1 + drafts`` tokens (window logits, the window's
    first row), each after a cold prefill of the common history; K4's plan
    for each (kernel, pages per split, keys per step), the two tokens'
    logit margin in each, and the largest difference of the two rows."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import kernel_plan
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is None:
        return {"index": None}
    if t == 0:  # the prefills disagree: nothing to compare the windows with
        return {"index": 0, "explained": False}
    hist = prompt + a[:t - 1]
    uid = 1 << 26
    rows, plans = {}, {}
    cfg = engine.model().config
    for kind, feed in (("decode", [a[t - 1]]), ("verify", [a[t - 1]] + a[t:t + drafts])):
        engine.put([uid], [hist], adopt_prefix=False)
        seq = engine._state_manager.get_sequence(uid)
        engine._model.maybe_allocate_kv(seq, len(feed))
        B = 1 << max(0, (seq.cur_allocated_blocks - 1).bit_length())
        N = 1 << max(0, (len(feed) - 1).bit_length())
        q = torch.empty(1, N, cfg.num_attention_heads, cfg.head_dim_, dtype=torch.bfloat16,
                        device="cuda")
        cache = engine._state_manager.kv_cache.cache
        bt = torch.empty(1, B, dtype=torch.int32, device="cuda")
        plans[kind] = list(kernel_plan(q, cache, bt, page_size=64))
        out = engine.put([uid], [feed], window_logits=kind == "verify")
        rows[kind] = (out[0, 0] if kind == "verify" else out[0]).float()
        engine.flush(uid)
    dec, ver = rows["decode"], rows["verify"]
    margins = {k: float(r[a[t]] - r[b[t]]) for k, r in rows.items()}
    diff = float((dec - ver).abs().max())
    return {"index": t, "tokens": [a[t], b[t]], "plans": plans, "margins": margins,
            "max_abs_logit_diff": diff,
            "explained": min(abs(m) for m in margins.values()) <= SPEC_MARGIN_RATIO * diff}


def phase_serving_speculative(kernels: list) -> dict:
    """Llama-3-8B at its full 32 layers (seeded random bf16 weights,
    64-token blocks in SERVING_KV_BYTES) with prefix caching on.
    (a) The prefix cache: eight prompts share a 2048-token prefix with
    distinct tails of 64-200 tokens, the last sharing 30 tokens of the
    first's tail (a mid-block divergence). Each is put cold
    (``adopt_prefix=False``) and flushed, then put again, adopting: tokens
    fed, adopted blocks, forks, first-token ms of each; adopted logits
    within the serving phase's prefill-against-decode bound (5% of
    max|logit|) of the cold ones; block conservation after the flushes.
    (b) Speculation: eight prompts of a repeated 64-token pattern, 64 new
    tokens, d 4, n-gram 2: plain greedy at window 16, the per-token verify
    and the fused speculative window at 16, the cache reset before each run
    so that every run prefills alike, each run twice (the first captures,
    the second replays). Their streams must be equal, or each
    divergence explained (``spec_divergence``: the two tokens' margin
    within SPEC_MARGIN_RATIO times the two forwards' difference there);
    then a sampled pair (SPEC_SAMPLED_KW, d 3), fused against per-token,
    equal streams. Drafted and accepted counts, decode tokens/s on
    generate's wall time, the captures and their pool bytes. (c) ``score``
    of two prompts against the log-softmax of a cold window put. K4's and
    K5's counts are set to 0 before (a) and read after (c); K4's wgmma
    tiles and decode kernel and K5 must have run."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2.config_v2 import (DSStateManagerConfig, KVCacheConfig,
                                                            RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import per_token_kv_bytes
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.normalization import rms_norm
    from deepspeed_tpu_torch.ops.paged_attention import KERNEL_COUNTERS, paged_attention

    cfg = LlamaConfig.llama3_8b()
    V, bs = cfg.vocab_size, 64
    per_block = bs * per_token_kv_bytes(KVCacheConfig(
        block_size=bs, cache_shape=(cfg.num_hidden_layers, cfg.num_key_value_heads,
                                    cfg.head_dim_), cache_dtype="bfloat16"))
    num_blocks = SERVING_KV_BYTES // per_block
    free_memory()
    t0 = time.monotonic()
    engine = build_llama_engine(
        cfg, engine_config=RaggedInferenceEngineConfig(
            num_kv_blocks=num_blocks, enable_prefix_caching=True,
            state_manager=DSStateManagerConfig(max_ragged_batch_size=4096)),
        seed=0, dtype=torch.bfloat16, kv_block_size=bs)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    sm, model = engine._state_manager, engine.model()
    pc = sm.prefix_cache
    counters = [(paged_attention, c) for c in ("launches", ) + KERNEL_COUNTERS] + \
        [(rms_norm, "launches")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    checks = {}

    # (a) the prefix cache
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, V, SPEC_PREFIX).tolist()
    tails = [rng.integers(0, V, n).tolist() for n in SPEC_TAILS]
    tails[-1] = tails[0][:SPEC_FORK_AT] + tails[-1]
    prompts = [prefix + t for t in tails]

    def timed_put(uid, prompt, **kw):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits = engine.put([uid], [prompt], **kw)[0].float()
        torch.cuda.synchronize()
        return logits, 1e3 * (time.monotonic() - t)

    # cold: every token fed, nothing left in the cache
    cold, cold_ms = [], []
    for u, p in enumerate(prompts):
        logits, ms = timed_put(u, p, adopt_prefix=False, defer_register={u})
        cold.append(logits.cpu())
        cold_ms.append(ms)
        engine._scrub_pending(u)
        engine.flush(u)
    cold_cached = len(pc._by_block)
    # the shared prefix alone (a system prompt), then each prompt adopting
    engine.put([99], [prefix])
    engine.flush(99)
    adopted, adopted_ms, fed, adopted_blocks, forks = [], [], [], [], []
    for u, p in enumerate(prompts):
        saved, cow = pc.stats["saved_tokens"], pc.stats["cow_forks"]
        logits, ms = timed_put(100 + u, p)
        adopted.append(logits.cpu())
        adopted_ms.append(ms)
        fed.append(len(p) - (pc.stats["saved_tokens"] - saved))
        adopted_blocks.append(len(sm.get_sequence(100 + u).adopted_blocks))
        forks.append(pc.stats["cow_forks"] - cow)
    live = set()
    for seq in sm.tracked_sequences.values():
        live.update(seq.kv_blocks)
    conserved_live = (sm._allocator.free_blocks + len(live)
                      + len({b for b in pc._by_block if b not in live}) == num_blocks)
    for u in range(len(prompts)):
        engine.flush(100 + u)
    conserved = (sm._allocator.free_blocks + len(pc._by_block) == num_blocks
                 and engine.free_blocks == num_blocks)
    diffs = [float((a - c).abs().max()) for a, c in zip(adopted, cold)]
    bounds = [0.05 * float(c.abs().max()) for c in cold]
    prefix_rec = {"prompt_lens": [len(p) for p in prompts], "cold_tokens_fed": [len(p) for p in prompts],
                  "adopted_tokens_fed": fed, "adopted_blocks": adopted_blocks,
                  "cow_forks": forks, "first_token_ms_cold": cold_ms,
                  "first_token_ms_adopted": adopted_ms,
                  "adopted_vs_cold_max_abs_diff": diffs, "bounds": bounds,
                  "report": engine.prefix_cache_report()}
    checks.update({
        "prefix_cold_puts_left_nothing_cached": cold_cached == 0,
        "prefix_adopted_logits_within_prefill_decode_bound": all(
            d <= b for d, b in zip(diffs, bounds)),
        "prefix_every_prompt_adopted_the_prefix": adopted_blocks == [SPEC_PREFIX // bs] * 8,
        "prefix_one_mid_block_fork": forks == [0] * 7 + [1],
        "prefix_fed_the_tails": fed == [len(t) for t in tails[:-1]]
        + [len(tails[-1]) - SPEC_FORK_AT],
        "prefix_blocks_conserved_live": conserved_live,
        "prefix_blocks_conserved_after_flushes": conserved,
    })

    # (b) speculation
    prompts_b = [(rng.integers(0, V, SPEC_PATTERN).tolist() * (SPEC_PROMPT // SPEC_PATTERN))
                 for _ in range(8)]
    spec_kw = dict(speculative="prompt_lookup", num_draft_tokens=SPEC_DRAFTS,
                   draft_ngram=SPEC_NGRAM)

    def run(window, **kw):
        """``generate`` twice from a reset cache: the first run captures its
        keys' steps, the second (warm) replays what it can."""
        recs, outs = {}, []
        for name in ("first", "warm"):
            sm.reset_prefix_cache()
            graphs, pool = len(model._graphs), model.graph_pool_bytes
            torch.cuda.synchronize()
            t = time.monotonic()
            outs.append(engine.generate(prompts_b, max_new_tokens=SPEC_NEW,
                                        fused_decode_window=window, **kw))
            torch.cuda.synchronize()
            s = time.monotonic() - t
            n = sum(len(o) for o in outs[-1])
            recs[name] = {"generate_s": s, "new_tokens": n, "decode_tokens_per_s": n / s,
                          "spec_stats": (dict(engine.last_spec_stats) if "speculative" in kw
                                         else None),
                          "captures": len(model._graphs) - graphs,
                          "capture_pool_bytes": model.graph_pool_bytes - pool}
        recs["warm_stream_equals_first"] = outs[0] == outs[1]
        return outs[0], recs

    runs = {}
    plain, runs["plain_greedy_k16"] = run(16)
    per_token, runs["spec_per_token"] = run(1, **spec_kw)
    fused, runs["spec_fused_k16"] = run(16, **spec_kw)
    s_kw = dict(spec_kw, num_draft_tokens=SPEC_SAMPLED_DRAFTS, **SPEC_SAMPLED_KW)
    s_fused, runs["sampled_spec_fused_k16"] = run(16, **s_kw)
    s_per_token, runs["sampled_spec_per_token"] = run(1, **s_kw)
    divergences = {}
    for name, (a, b) in {"per_token_vs_plain": (plain, per_token),
                         "fused_vs_plain": (plain, fused),
                         "fused_vs_per_token": (per_token, fused)}.items():
        divergences[name] = [dict(spec_divergence(engine, p, x, y, SPEC_DRAFTS), prompt=i)
                             for i, (p, x, y) in enumerate(zip(prompts_b, a, b)) if x != y]
    sampled_equal = s_fused == s_per_token
    checks.update({
        "spec_outputs_all_new_tokens": all(
            len(o) == SPEC_NEW and all(0 <= t < V for t in o)
            for o in plain + per_token + fused + s_fused + s_per_token),
        "spec_greedy_streams_equal_or_explained": all(
            d["explained"] for ds in divergences.values() for d in ds),
        "spec_drafts_fired": all(runs[k]["first"]["spec_stats"]["drafted"] > 0
                                 for k in ("spec_per_token", "spec_fused_k16")),
        "spec_sampled_fused_equals_per_token": sampled_equal,
        "spec_fused_captured": runs["spec_fused_k16"]["first"]["captures"] > 0,
    })

    # (c) score against the log-softmax of a cold window put
    score_prompts = [prompts_b[0][:300], prompts[1][:700]]
    got = engine.score([500, 501], score_prompts)
    logits = engine.put([502, 503], score_prompts, window_logits=True, adopt_prefix=False)
    score_diff = 0.0
    for i, (g, p) in enumerate(zip(got, score_prompts)):
        lp = torch.log_softmax(logits[i, :len(p) - 1].double(), -1)
        ref = lp.gather(1, torch.tensor(p[1:], device=lp.device)[:, None])[:, 0].cpu().numpy()
        score_diff = max(score_diff, float(np.abs(g - ref).max()))
    engine.flush(502), engine.flush(503)
    checks["score_matches_cold_window_log_softmax"] = score_diff <= 1e-6
    launches = {f"{'paged_attention' if fn is paged_attention else 'rms_norm'}"
                f"{'' if attr == 'launches' else '_' + attr}": getattr(fn, attr)
                for fn, attr in counters}
    checks["kernels_ran"] = (launches["paged_attention_wgmma_launches"] > 0
                             and launches["paged_attention_decode_launches"] > 0
                             and launches["rms_norm"] > 0)
    checks["free_blocks_back_to_total"] = engine.free_blocks == num_blocks
    rec = {"phase": "serving_speculative", "gpu": gpu_identity(),
           "config": "llama3_8b (32 layers, random bf16 weights), prefix caching on",
           "engine_build_s": build_s, "kv_blocks": num_blocks,
           "prefix_cache": prefix_rec,
           "speculation": {"prompts": f"8 x {SPEC_PROMPT} tokens (a {SPEC_PATTERN}-token "
                                      "pattern repeated)", "new_tokens": SPEC_NEW,
                           "num_draft_tokens": SPEC_DRAFTS, "draft_ngram": SPEC_NGRAM,
                           "sampled": dict(SPEC_SAMPLED_KW, num_draft_tokens=SPEC_SAMPLED_DRAFTS),
                           "runs": runs, "divergences": divergences,
                           "sampled_first_divergence": None if sampled_equal else [
                               next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                               for a, b in zip(s_fused, s_per_token)],
                           "graphs": len(model._graphs), "graph_pool_bytes":
                           model.graph_pool_bytes},
           "score_max_abs_diff": score_diff, "launches": launches,
           "checks": checks, "ok": all(checks.values())}
    emit(rec)
    del engine, model, sm, pc
    free_memory()
    if not rec["ok"]:
        raise SystemExit(f"serving_speculative checks failed: {checks}")
    keys = {"paged_attention": "paged_attention", "rms_norm": "rms_norm",
            "paged_attention_wgmma": "paged_attention_wgmma_launches",
            "paged_attention_decode": "paged_attention_decode_launches"}
    for k in kernels:
        key = keys.get(k["name"])
        if key is not None:
            by_phase = k.setdefault("launches_by_phase", {"serving": k["launches"] or 0})
            by_phase["serving_speculative"] = launches[key]
            k["launches"] = sum(by_phase.values())
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # every phase resolves the attention route against an empty table of
    # measurements: no entry of an earlier run decides a main path
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    os.environ["DS_TPU_ATTN_CACHE_DIR"] = tempfile.mkdtemp(prefix="attn_cache_",
                                                           dir=build_dir)
    seconds = {}

    def timed(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        seconds[name] = time.monotonic() - t
        return out

    build = timed("build", phase_build)
    kernels = timed("kernels", phase_kernels)
    timed("parity", phase_parity)
    timed("train_parity", phase_train_parity)
    training = timed("training", phase_training)
    optimizers = timed("training_optimizers", phase_training_optimizers)
    mistral = timed("training_mistral", phase_training_mistral)
    gemma_training = timed("training_gemma2", phase_training_gemma2)
    fused = timed("training_fused", phase_training_fused)
    zero = timed("training_zero", phase_training_zero)
    grad_comm = timed("training_grad_comm", phase_training_grad_comm)
    zero3 = timed("training_zero3_scheduled", phase_training_zero3_scheduled)
    checkpoint = timed("training_checkpoint", phase_training_checkpoint)
    bf16 = timed("serving", phase_serving, kernels)
    timed("serving_int8", phase_serving_int8, kernels, bf16)
    del bf16
    free_memory()
    timed("serving_speculative", phase_serving_speculative, kernels)
    timed("serving_starcoder2", phase_serving_starcoder2, kernels)
    timed("serving_bloom", phase_serving_bloom, kernels)
    timed("serving_gemma2", phase_serving_gemma2, kernels)
    sparse = timed("sparse_attention", phase_sparse_attention)
    timed("attn_sweep", phase_attn_sweep)
    emit({"phase_seconds": seconds})
    runs = optimizers["runs"]
    # each kernel's launches in the main-path runs that count it: phase 5
    # and the Mistral runs for the attention kernels of bf16 training
    by_phase = {name: {"training": n} for name, n in training["launches"].items()}
    for run, rec in mistral["runs"].items():
        for name, n in rec["launches"].items():
            if n:
                by_phase.setdefault(name, {})[f"training_mistral/{run}"] = n
    for run, rec in fused["runs"].items():
        for name, n in rec.get("launches", {}).items():
            by_phase.setdefault(name, {})[f"training_fused/{run}"] = n
    by_phase["adam_step_"]["training_optimizers/adamw_fp16"] = runs["adamw_fp16"]["k7_launches"]
    for name, rec in zero["runs"].items():
        by_phase["adam_step_"][f"training_zero/{name}"] = rec["k7_launches"]
    for rk in zero["ranks"]:
        for name, rec in rk["runs"].items():
            by_phase["adam_step_"][f"training_zero/rank{rk['rank']}_{name}"] = rec["k7_launches"]
    for name, rec in grad_comm["runs"].items():
        by_phase["adam_step_"][f"training_grad_comm/{name}"] = rec["k7_launches"]
    for name, rec in zero3["runs"].items():  # K1/K2 and K7 under the store
        for kernel, n in rec["launches"].items():
            by_phase.setdefault(kernel, {})[f"training_zero3_scheduled/{name}"] = n
    for rk in zero3["ranks"]:
        for kernel, n in rk["run"]["launches"].items():
            by_phase[kernel][f"training_zero3_scheduled/rank{rk['rank']}"] = n
    for name, rec in checkpoint["runs"].items():
        by_phase["adam_step_"][f"training_checkpoint/{name}"] = rec["k7_launches"]
    by_phase["lion_step_"] = {"training_optimizers/lion_bf16": runs["lion_bf16"]["k7_launches"]}
    by_phase["lamb_update_"] = {
        "training_optimizers/lamb_bf16": runs["lamb_bf16"]["k7_launches"]}
    for rk in grad_comm["ranks"]:
        for name, rec in rk["runs"].items():
            if rec["k7_launches"]:
                by_phase["adam_step_"][f"training_grad_comm/rank{rk['rank']}_{name}"] = \
                    rec["k7_launches"]
            if rec["lamb_update_launches"]:
                by_phase["lamb_update_"][f"training_grad_comm/rank{rk['rank']}_{name}"] = \
                    rec["lamb_update_launches"]
    for name, n in runs["adamw_fp16"]["flash_fp16_launches"].items():
        by_phase[name + "_fp16"] = {"training_optimizers/adamw_fp16": n}
    for run, rec in sparse["runs"].items():
        for name, n in rec["launches"].items():
            by_phase.setdefault(name, {})[f"sparse_attention/{run}"] = n
    # the head-width-256 instances: K1/K2's launches in training_gemma2,
    # where they are the only flash launches (K3 has none on a main path)
    for name, n in gemma_training["launches"].items():
        if "attention" in name:
            by_phase[name + "_d256"] = {"training_gemma2": n}
    wrapper = {name: w for name, w, _, _ in K7_KERNELS}
    # each K7 body's launches over the whole flat buffer on the training
    # paths, against the plain version (phases 5 and 5b)
    path_checks = {"adam_step_": {"training": training["k7_path_check"],
                                  "adamw_fp16": runs["adamw_fp16"]["k7_path_check"],
                                  "training_fused": fused["k7_path_check"],
                                  "training_zero_rank1_stage3_shard":
                                  zero["ranks"][1]["runs"]["stage3"]["k7_shard_check"],
                                  "training_grad_comm_rank1_fp32_s2_bucket_shard":
                                  grad_comm["ranks"][1]["runs"]["fp32_s2_overlap"]
                                  ["k7_shard_check"],
                                  "training_zero3_scheduled_store_shard":
                                  zero3["runs"]["a_store_fp32"]["k7_store_check"],
                                  "training_zero3_scheduled_rank1_half_store":
                                  zero3["ranks"][1]["run"]["k7_shard_check"]},
                   "lion_step_": {"lion_bf16": runs["lion_bf16"]["k7_path_check"]},
                   "lamb_update_": {"lamb_bf16": runs["lamb_bf16"]["k7_path_check"]}}
    # ptxas's report beside the wgmma kernels of the narrower widths and K4's
    wgmma_rows = {"flash_attention_fwd": ("fwd_wgmma", "__nv_bfloat16, (int)128"),
                  "folded_attention_fwd": ("fwd_wgmma", "__nv_bfloat16, (int)128"),
                  "flash_attention_fwd_fp16": ("fwd_wgmma", "__half, (int)128"),
                  "paged_attention_wgmma": ("paged_attention_wgmma", "")}
    splash_passes = {name: key for key, name, _ in SPLASH_KERNELS}
    for k in kernels:
        if k["name"] in wgmma_rows:
            family, args = wgmma_rows[k["name"]]
            k["registers_and_spills"] = [e for e in build["wgmma_kernels"]
                                         if family in e["kernel"] and args in e["kernel"]]
        if k["name"] == "paged_attention_decode":
            k["registers_and_spills"] = build["decode_kernels"]
        if k["name"] in splash_passes:  # the bf16 instances the cases launch
            k["registers_and_spills"] = [e for e in build["splash_kernels"]
                                         if e.get("pass") == splash_passes[k["name"]]
                                         and e.get("dtype") == "__nv_bfloat16"]
        for kind in ("chunk", "decode"):
            if k["name"] == "paged_attention_f32_" + kind:
                k["registers_and_spills"] = [e for e in build["f32_kernels"]
                                             if f"paged_f32_{kind}" in e["kernel"]]
        if "_d256" in k["name"]:
            wrapper_name, suffix = k["name"].split("_d256")
            dtype = {"": "bfloat16", "_fp16": "float16"}.get(suffix, suffix[1:])
            k["registers_and_spills"] = d256_usage(build, wrapper_name, dtype)
        key = wrapper.get(k["name"], k["name"])
        if key in by_phase:
            k["launches"] = sum(by_phase[key].values())
            k["launches_by_phase"] = by_phase[key]
        if key in path_checks:
            k["main_path"] = path_checks[key]
            k["max_ulps"] = max([k["max_ulps"]] + [c["max_ulps"]
                                                   for c in path_checks[key].values()])
    emit({"kernels": kernels})
    print(gpu_identity(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
