#!/usr/bin/env python3
"""A/B of the attention kernels of one source tree on a CUDA GPU: K1's
forward (Llama-3-8B's training shape, with softcap 50, causal at S 8192,
Gemma-2's D 256 under the 4096 window with its cap) and K4 on the
multi-row shapes of the serving paths (Gemma-2's and StarCoder2's 768-row
chunks straddling the window, BLOOM's ALiBi chunk, Llama's prefill wave,
Llama's 768-row chunk over an int8 cache deep in the cache, the mixed
batch) and on the decode steps of the four families (Llama, StarCoder2's
window, BLOOM's ALiBi, Gemma-2's softcap without and with its window) over
a bf16 and an int8 cache, graph-timed, each time beside the row error
against the plain version and the kernel that ran; then K4 with fp32
queries (FP32): Gemma-2's 768-row chunk at 3700 deep on a global and on a
window layer and its decode step over an fp32 cache, Llama's 768-row
chunk 2200 deep and its decode step over an int8 cache.

    python3 flash_ab.py TREE TAG [--flex] [--fp32] [--fp32-engine] [--k8]
                             [--k8-limits=N,N,...] [--rows] [--norm-loads] [--k7] [--zero]

TREE is the root of a checkout (this one: ``.``; another commit: unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists,
e.g. ``build/parent``); its own kernels, wrappers and ``chip_smoke.py``
cases run, its library built under it. ``--flex`` adds, for reference
only, flex_attention over Gemma-2's and StarCoder2's K4 chunks with their
keys gathered into contiguous K/V (the cap and the window as its
``score_mod`` and mask): not K4's function, which reads the paged cache.
``--fp32`` runs the FP32 cases alone; ``--fp32-engine`` adds Gemma-2-9B's
fp32 engine as chip_smoke.py's ``serving_gemma2`` builds it (full depth,
the weights as first drawn), timing each forward of its 5120-token
prompt's prefill, fed twice in 768-token chunks, and of one decode step.
``--k8`` runs K8 alone instead: dq (with its sum of split rows, where the
tree has one) and, as controls, the forward and dk/dv at chip_smoke.py's
``SPLASH_SHAPE`` under its four layouts (fixed, BigBird, Longformer at
block 16, fixed at block 64), each pass's time, bound and row error
against its plain version, with the plans' shape where the tree has them;
``--k8-limits`` repeats the cases at those segment limits (a tree whose
``SplashTables.build`` takes ``limit``). ``--rows`` runs the row kernels
alone instead: K5 (bf16 ``[8, 4096]``, ``[768, 4096]``; the fp32 scale at
``[8, 3584]``, ``[768, 3584]``), K5b (``[8, 4608]``, ``[768, 4608]``) and K6
at the int8 engine's five shapes (block 512), each graph-timed through the
tree's wrapper (K6 also by CUDA events, host cost included) beside its
bound and its error against the plain version, an empty kernel's graph
time where the tree has one, and the norm wrappers' host cost a call at
decode rows (``wrapper_us``). ``--norm-loads`` measures the row norms'
weight loads instead (a tree whose norm entry points take them): at 1 to
768 rows of each serving width (``NORM_WIDTHS``), the weights loaded
before the statistic and after it, each forced through the C entry point,
graph-timed and held against the plain version, and the fewest rows from
which the late loads are as fast at every larger count (the plan's
``kLateWeightsMinRows`` in ``csrc/row_norm.cuh``). ``--k7`` runs K7 alone
instead: each body (AdamW, Adam with L2, Lion, LAMB's first pass) through
the tree's ``chip_smoke.py`` ``_k7_case`` at one Llama-3-8B layer's
parameters (``LAYER_PARAMS``), graph-timed beside its bound, its ulps
against the plain version and torch.optim's fused step, and the
fingerprints of one AdamW step's outputs from a seeded state (equal
fingerprints across trees: the same bits), through whichever scalars the
tree's ``adam_step_`` takes (numbers, or device tensors). ``--zero`` runs
the tree's ``chip_smoke.py`` ``training_zero`` part (a) alone instead:
world 1 over NCCL, ZeRO stages 0-3 at the Llama-3-8B width
(``zero_run``), each stage's step and window times, losses, peak memory
and K7 launches.
Prints one JSON line tagged TAG. To compare two commits on one card, run them in turns in one
command: parent, change, change, parent.
"""

import json
import os
import sys
import time


def fwd_case(cs, gen, name, B, S, causal, widths=(32, 8, 128), window=None, softcap=None,
             q_scale=1.0):
    """K1's forward in bf16 at one shape: ms (CUDA events, 20 calls), the
    bound, and o's row error against the plain version."""
    import torch
    from deepspeed_tpu_torch.ops import attention as fa
    H, KV, D = widths
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (H, KV, KV))
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(torch.bfloat16)
    opts = dict(window=window, softcap=softcap)
    o, _ = fa.flash_attention_fwd(q, k, v, causal, **opts)
    o_ref, _ = fa.flash_attention_fwd_reference(q, k, v, causal, **opts)
    torch.cuda.synchronize()
    err = cs.row_rel_err(o, o_ref, 2.0 ** -16 / cs.FLASH_ROW_TOL["bfloat16"])
    del o, o_ref
    pairs = cs.visible_pairs(S, causal, window)
    rec = {"case": name, "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "causal": causal,
                                   "window": window, "softcap": softcap},
           "row_rel_err": err,
           "ms": cs.time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal, **opts)),
           "bound_ms": 4 * D * pairs * H * B / cs.BF16_FLOPS * 1e3}
    del q, k, v
    cs.free_memory()
    return rec


# K4 cases: (name, seen, n_new, N, B, options), the chip_smoke.py phase-2
# shapes; widths by name
PAGED = (
    ("gemma2_chunk_window", [3700], [768], 768, 70, "gemma2"),
    ("starcoder2_chunk_window", [3700], [768], 768, 84, "starcoder2"),
    ("bloom_alibi_chunk", [768], [768], 768, 24, "bloom"),
    ("llama_prefill_wave", [0, 0, 0, 0], [128, 256, 384, 0], 512, 8, "llama"),
    ("llama_chunk_int8_deep", [2200], [768], 768, 47, "llama_int8"),
    ("llama_mixed", [100, 250, 400, 550, 700, 999, 300, 0], [1, 1, 1, 1, 1, 1, 16, 0], 16,
     16, "llama"),
)


# K4 decode steps of the four serving families, 8 sequences at the
# chip_smoke.py phase-2 histories, each over a bf16 and an int8 cache:
# (name, seen, B, widths by name)
DECODE_SEEN = {"llama": [128 * (i + 1) + 22 for i in range(8)],
               "starcoder2": [4200, 4608, 5000, 5184, 6000, 4095, 8000, 300],
               "bloom": [2048 + 5, 1536 + 9, 1024 + 13, 1024 + 17, 512 + 21, 256 + 25,
                         128 + 29, 128 + 31],
               "gemma2": [5120 + 5, 4864 + 9, 4352 + 13, 3072 + 17, 2048 + 21, 1024 + 25,
                          512 + 29, 128 + 31]}
DECODE = (
    ("llama_decode", "llama", 17, "llama"),
    ("starcoder2_decode_window", "starcoder2", 126, "starcoder2"),
    ("bloom_alibi_decode", "bloom", 33, "bloom"),
    ("gemma2_decode_global", "gemma2", 82, "gemma2_global"),
    ("gemma2_decode_window", "gemma2", 82, "gemma2"),
)


# K4 with fp32 queries: (name, seen, n_new, N, B, widths by name, int8,
# graph-timed), the chip_smoke.py phase-2 fp32 shapes
FP32 = (
    ("gemma2_chunk_fp32_global", [3700], [768], 768, 70, "gemma2_global", False, False),
    ("gemma2_chunk_fp32_window", [3700], [768], 768, 70, "gemma2", False, False),
    ("llama_chunk_fp32_int8_deep", [2200], [768], 768, 47, "llama", True, False),
    ("gemma2_decode_fp32_global", DECODE_SEEN["gemma2"], [1] * 8, 1, 82, "gemma2_global", False,
     True),
    ("llama_decode_fp32_int8", DECODE_SEEN["llama"], [1] * 8, 1, 17, "llama", True, True),
)


def k8_case(cs, gen, name, config, block, limit=None):
    """K8's dq, forward and dk/dv in bf16 at ``SPLASH_SHAPE`` under one
    layout, each pass through its wrapper (second passes included): each
    pass's ms (a CUDA graph of 20 calls; ``events_ms``: CUDA
    events around 20 calls through the wrapper), its bound (the larger of
    each input read once and each output written once at 3.35 TB/s and its
    operations, 4·D / 6·D / 8·D per active pair, at 989 TFLOP/s; the block
    tables' few KB left out) and its largest row error against the plain
    version (the backward passes take the plain forward's lse)."""
    import torch
    from deepspeed_tpu_torch.ops.attention import attention_delta
    from deepspeed_tpu_torch.ops.sparse_attention import splash as sp
    B, H, S, D = (cs.SPLASH_SHAPE[k] for k in ("B", "H", "S", "D"))
    _, layout = cs.splash_layout(config, block)
    tables = sp.SplashTables.build(layout, block, "cuda",
                                   **({} if limit is None else {"limit": limit}))
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o_ref, lse_ref = sp.splash_attention_fwd_reference(q, k, v, layout, block)
    args = (q, k, v, do, lse_ref, attention_delta(o_ref, do))
    passes = {
        "fwd": (lambda: sp.splash_attention_fwd(q, k, v, tables), 4, [o_ref]),
        "dq": (lambda: sp.splash_attention_bwd_dq(*args, tables), 6,
               [sp.splash_attention_bwd_dq_reference(*args, layout, block)]),
        "dkdv": (lambda: sp.splash_attention_bwd_dkdv(*args, tables), 8,
                 list(sp.splash_attention_bwd_dkdv_reference(*args, layout, block)))}
    pairs = int(layout.sum()) * (B * H // layout.shape[0]) * block * block
    qb, rb = B * H * S * D * 2, B * H * S * 4
    moved = {"fwd": 4 * qb + rb, "dq": 5 * qb + 2 * rb, "dkdv": 6 * qb + 2 * rb}
    floor = 2.0 ** -16 / cs.FLASH_ROW_TOL["bfloat16"]
    rec = {"case": name, "layout": config, "block": block, "limit": limit}
    if hasattr(tables, "plan"):
        rec["plan"] = {"fwd": tables.plan.stats, "dkdv": tables.plan_t.stats}
    for key, (fn, ops, want) in passes.items():
        out = fn()
        got = [out] if torch.is_tensor(out) else list(out)[:len(want)]
        torch.cuda.synchronize()
        bound = max(ops * D * pairs / cs.BF16_FLOPS, moved[key] / cs.HBM_BYTES_PER_S) * 1e3
        rec[key] = {"ms": cs.graph_time_ms(fn), "events_ms": cs.time_ms(fn), "bound_ms": bound,
                    "row_rel_err": max(cs.row_rel_err(x, r, floor) for x, r in zip(got, want))}
        del out, got
    del q, k, v, do, o_ref, lse_ref, args, passes, tables
    cs.free_memory()
    return rec


# K6's cases: Llama-3-8B's layer kernels at the engine's block of 512 and
# a ragged tail, chip_smoke.py's phase-2 shapes
QUANT_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096 * 3 + 100, ))


def rows_cases(cs, gen) -> dict:
    """K5, K5b and K6 at the main path's shapes through the tree's wrappers
    (chip_smoke.py's ``_rms_case`` and ``_ln_case`` for the norms)."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer import (quantize_int8_blockwise,
                                                   quantize_int8_blockwise_reference)
    norms = [{"kernel": "rms_norm", **cs._rms_case(rows, 4096, gen)} for rows in (8, 768)]
    norms += [{"kernel": "rms_norm_fp32_scale", **cs._rms_case(rows, 3584, gen, fp32_scale=True)}
              for rows in (8, 768)]
    norms += [{"kernel": "layer_norm", **cs._ln_case(rows, 4608, gen, torch.bfloat16)}
              for rows in (8, 768)]
    quant = []
    for shape in QUANT_SHAPES:
        x = (0.02 * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)
        v, s = quantize_int8_blockwise(x, 512)
        v_ref, s_ref = quantize_int8_blockwise_reference(x, 512)
        torch.cuda.synchronize()
        quant.append({
            "kernel": "quantize_int8_blockwise", "shape": list(shape), "block": 512,
            "equal": torch.equal(v, v_ref) and torch.equal(s.view(torch.int32),
                                                           s_ref.view(torch.int32)),
            "ms": cs.graph_time_ms(lambda: quantize_int8_blockwise(x, 512)),
            "events_ms": cs.time_ms(lambda: quantize_int8_blockwise(x, 512)),
            "bound_ms": (x.numel() * 2 + v.numel() + s.numel() * 4) / cs.HBM_BYTES_PER_S * 1e3})
        del x, v, s, v_ref, s_ref
    cs.free_memory()
    out = {"norms": [{k: c.get(k) for k in ("kernel", "shape", "ms", "bound_ms", "max_abs_err",
                                            "library_ms")} for c in norms],
           "quantize": quant}
    if hasattr(cs, "launch_floor_ms"):
        out["launch_floor_ms"] = cs.launch_floor_ms()
    out["wrapper_us"] = wrapper_us()
    return out


def k7_cases(cs, gen) -> dict:
    """K7's bodies at one 8B layer (``_k7_case``), then one AdamW step's
    output fingerprints from a seeded state."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    cases = []
    for body in ("adamw", "adam_l2", "lion", "lamb_pass"):
        gen.manual_seed(21)  # every tree on the same inputs
        rec = cs._k7_case(gen, body, cs.LAYER_PARAMS)
        cases.append({k: rec.get(k) for k in ("case", "n", "ms", "bound_ms", "max_ulps",
                                              "plain_ms", "library_ms")})
    n = cs.LAYER_PARAMS
    gen.manual_seed(22)
    p, g, m = (s * torch.randn(n, generator=gen, device="cuda") for s in (0.02, 1e-3, 1e-4))
    v = 1e-8 * torch.rand(n, generator=gen, device="cuda")
    scalars = ((fo.device_scalar(1e-4, "cuda"), fo.device_scalar(3, "cuda"))
               if hasattr(fo, "device_scalar") else (1e-4, 3))
    fo.adam_step_(p, g, m, v, *scalars, weight_decay=0.1)
    prints = {k: cs.fingerprint(t) for k, t in zip("pmv", (p, m, v))}
    del p, g, m, v
    cs.free_memory()
    return {"cases": cases, "adamw_step_fingerprints": prints}


def wrapper_us(calls: int = 2000) -> dict:
    """The norm wrappers' host cost a call at decode rows: ``calls`` calls
    in a row on the host clock, the device synchronized before and after,
    over ``calls`` (the kernels take ~2 us, so the host sets the pace)."""
    import torch
    from deepspeed_tpu_torch.ops.normalization import layer_norm, rms_norm
    x16 = torch.randn(8, 4096, device="cuda").to(torch.bfloat16)
    x36 = torch.randn(8, 3584, device="cuda").to(torch.bfloat16)
    x46 = torch.randn(8, 4608, device="cuda").to(torch.bfloat16)
    w16, w36 = torch.ones(4096, device="cuda", dtype=torch.bfloat16), torch.ones(3584, device="cuda")
    w46 = torch.ones(4608, device="cuda", dtype=torch.bfloat16)
    cases = {"rms_norm [8, 4096]": lambda: rms_norm(x16, w16),
             "rms_norm fp32 scale [8, 3584]": lambda: rms_norm(x36, w36),
             "layer_norm [8, 4608]": lambda: layer_norm(x46, w46, w46)}
    out = {}
    for name, fn in cases.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) / calls * 1e6
    return out


# the row norms' serving widths: Llama-3-8B's RMSNorm (bf16), Gemma-2's with
# the fp32 scale and its fp32 engine's (fp32 rows), StarCoder2's LayerNorm
NORM_WIDTHS = (("rms_norm", 4096, "bfloat16", "bfloat16"),
               ("rms_norm", 3584, "bfloat16", "float32"),
               ("rms_norm", 3584, "float32", "float32"),
               ("layer_norm", 4608, "bfloat16", "bfloat16"))
NORM_ROWS = (1, 8, 37, 128, 256, 512, 768)
NORM_TOL = {"bfloat16": 6.25e-2, "float32": 1e-4}


def norm_loads(cs, gen) -> dict:
    """Each NORM_WIDTHS row norm at NORM_ROWS rows with its weights loaded
    early (0) and late (1), forced through the entry point, graph-timed;
    the error of each against the plain version (NORM_TOL by x's dtype)."""
    import torch
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import normalization as nm
    lib, points, ok = _build.lib(), [], True
    for kind, d, dt, wdt in NORM_WIDTHS:
        dtype, w_dtype = getattr(torch, dt), getattr(torch, wdt)
        ln = kind == "layer_norm"
        for rows in NORM_ROWS:
            x = (torch.randn(rows, d, generator=gen, device="cuda")
                 + (3 * torch.rand(rows, 1, generator=gen, device="cuda") if ln else 0)).to(dtype)
            w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
            b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
            out = torch.empty_like(x)
            ref = nm.layer_norm_reference(x, w, b) if ln else nm.rms_norm_reference(x, w)
            codes = (_build.dtype_code(dtype), _build.dtype_code(w_dtype))

            def run(late):
                stream = torch.cuda.current_stream().cuda_stream
                if ln:
                    return lib.dstt_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                               out.data_ptr(), rows, d, 1e-5, codes[0], late,
                                               stream)
                return lib.dstt_rms_norm(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                                         1e-6, *codes, late, stream)
            point = {"kernel": kind, "d": d, "dtype": dt, "w_dtype": wdt, "rows": rows,
                     "bound_ms": (2 * rows * d * x.element_size()
                                  + (2 if ln else 1) * d * w.element_size())
                     / cs.HBM_BYTES_PER_S * 1e3}
            for name, late in (("early", 0), ("late", 1)):
                _build.check(run(late), kind)
                err = (out.float() - ref.float()).abs().max().item()
                ok &= err <= NORM_TOL[dt]
                point[name + "_max_abs_err"] = err
                point[name + "_ms"] = cs.graph_time_ms(lambda: run(late))
            points.append(point)
            del x, w, b, out, ref
    late_from = {}
    for kind, d, dt, wdt in NORM_WIDTHS:
        mine = [p for p in points if (p["kernel"], p["d"], p["dtype"], p["w_dtype"])
                == (kind, d, dt, wdt)]
        late_from[f"{kind} {d} {dt}/{wdt}"] = next(
            (p["rows"] for i, p in enumerate(mine)
             if all(q["late_ms"] <= q["early_ms"] for q in mine[i:])), None)
    return {"timing": "cuda graph", "points": points, "ok": ok, "late_wins_from": late_from}


def paged_kw(cs, kind):
    return {"gemma2": dict(widths=cs.GEMMA2_PAGED, window=cs.GEMMA2_WINDOW,
                           softcap=cs.GEMMA2_ATTN_CAP, q_scale=cs.CAP_Q_SCALE),
            "gemma2_global": dict(widths=cs.GEMMA2_PAGED, softcap=cs.GEMMA2_ATTN_CAP,
                                  q_scale=cs.CAP_Q_SCALE),
            "starcoder2": dict(widths=cs.SC2_PAGED, window=cs.SC2_WINDOW),
            "bloom": dict(widths=cs.BLOOM_PAGED, alibi=True),
            "llama": {}, "llama_int8": dict(int8=True)}[kind]


def flex_chunk(cs, gen, seen, n_new, widths, window=None, softcap=None, q_scale=1.0):
    """flex_attention (compiled) over one sequence's chunk with its keys
    gathered contiguous: [1, H, N, D] queries at positions seen.., [1, KV,
    seen + N, D] keys, causal from seen and the window as the mask, the cap
    as the score_mod. A yardstick only: K4 reads the paged cache."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    KV, G, D = widths["KV"], widths["G"], widths["D"]
    H, L = KV * G, seen + n_new
    q = (q_scale * torch.randn(1, H, n_new, D, generator=gen, device="cuda")).to(torch.bfloat16)
    k, v = (torch.randn(1, KV, L, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))

    def mask_mod(b, h, q_idx, kv_idx):
        keep = kv_idx <= q_idx + seen
        return keep & (q_idx + seen - kv_idx < window) if window else keep

    def cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(mask_mod, B=None, H=None, Q_LEN=n_new, KV_LEN=L, device="cuda")
    torch._dynamo.reset()  # a fresh compile for each case
    fn = torch.compile(flex_attention)
    kw = dict(block_mask=mask, enable_gqa=True, score_mod=cap if softcap else None)
    fn(q, k, v, **kw)
    return cs.time_ms(lambda: fn(q, k, v, **kw))


def fp32_engine(cs) -> dict:
    """Gemma-2-9B's fp32 engine (chip_smoke.py serving_gemma2's): each
    forward's seconds (host clock around a synchronized forward) over
    prefill_and_decode on a 5120-token prompt, and K4's launches."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.module_inject import GEMMA2_9B, policy_for
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention as pa
    cfg = policy_for("gemma2").config_from_hf(GEMMA2_9B)
    engine = build_llama_engine(
        cfg, params=cs.gemma2_random_model(cfg, torch.float32), dtype=torch.float32,
        kv_block_size=64,
        engine_config=RaggedInferenceEngineConfig(num_kv_blocks=cs.GEMMA2_FP32_BLOCKS))
    inner, steps = engine.model().forward, []
    counters = sorted(k for k in vars(pa) if k.endswith("launches"))

    def timed(batch, **kw):
        before = [getattr(pa, c) for c in counters]
        torch.cuda.synchronize()
        t = time.monotonic()
        out = inner(batch, **kw)
        torch.cuda.synchronize()
        steps.append((batch.n_tokens, time.monotonic() - t,
                      {c: getattr(pa, c) - b for c, b in zip(counters, before)
                       if getattr(pa, c) != b}))
        return out
    engine.model().forward = timed
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 5120).tolist()
    cs.prefill_and_decode(engine, 2000, prompt)
    chunks = [(n, sec) for n, sec, _ in steps if n > 1]
    second = chunks[len(chunks) // 2:]  # the prompt fed again, warm
    rec = {"forwards": [{"tokens": n, "s": sec, "k4": k} for n, sec, k in steps],
           "prefill_s": sum(sec for _, sec in chunks),
           "prefill_tokens_per_s_second_pass": sum(n for n, _ in second) / sum(s for _, s in second),
           "decode_step_ms": 1e3 * next(sec for n, sec, _ in steps if n == 1)}
    del engine
    cs.free_memory()
    return rec


def zero_cases(cs) -> dict:
    """``training_zero`` (a) from the tree: stages 0-3 at world 1 over NCCL
    (a ``file://`` store), each 3 steps and a 2-step window."""
    import tempfile
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="zero_ab_", dir=os.path.join(cs.ROOT, "build"))
    os.environ["DS_TPU_ATTN_CACHE_DIR"] = tempfile.mkdtemp(prefix="attn_cache_", dir=tmp)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=0, world_size=1)
    out = {}
    try:
        for stage in (0, 1, 2, 3):
            engine, rec = cs.zero_run(stage, None, check_sync=True)
            out[f"stage{stage}"] = {k: rec[k] for k in (
                "window_ms_per_step", "step_ms", "losses", "peak_memory_gib", "k7_launches")}
            del engine
            cs.free_memory()
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 2
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    t = time.monotonic()
    _build.lib()
    out = {"tree": tag, "gpu": cs.gpu_identity(), "build_s": time.monotonic() - t,
           "fwd": [], "paged": [], "fp32": []}
    gen, gen32 = torch.Generator(device="cuda"), torch.Generator(device="cuda")
    gen.manual_seed(7)
    gen32.manual_seed(8)  # the fp32 cases' own: the others' inputs stay as they were
    if "--rows" in sys.argv:
        gen.manual_seed(15)  # every tree on the same inputs
        out["rows"] = rows_cases(cs, gen)
        print(json.dumps(out), flush=True)
        return 0
    if "--norm-loads" in sys.argv:
        gen.manual_seed(15)
        out["norm_loads"] = norm_loads(cs, gen)
        print(json.dumps(out), flush=True)
        return 0 if out["norm_loads"]["ok"] else 1
    if "--zero" in sys.argv:
        out["zero"] = zero_cases(cs)
        print(json.dumps(out), flush=True)
        return 0
    if "--k7" in sys.argv:
        out["k7"] = k7_cases(cs, gen)
        print(json.dumps(out), flush=True)
        return 0
    if "--k8" in sys.argv:
        limits = [None] + [int(x) for a in sys.argv if a.startswith("--k8-limits=")
                           for x in a.split("=", 1)[1].split(",")]
        out["k8"] = []
        for limit in limits:
            gen.manual_seed(13)  # every tree and limit on the same inputs
            out["k8"] += [k8_case(cs, gen, name, config, block, limit)
                          for name, config, block in cs.SPLASH_LAYOUTS]
        print(json.dumps(out), flush=True)
        return 0
    for name, seen, n_new, N, B, kind, int8, graph in FP32:
        r = cs._paged_case(gen32, name, seen, n_new, N=N, B=B, graph=graph, int8=int8,
                           dtype=torch.float32, **paged_kw(cs, kind))
        out["fp32"].append({k: r.get(k) for k in (
            "case", "path", "ms", "plain_ms", "bound_ms", "bound_by", "row_rel_err",
            "max_abs_err", "round_p_excess", "timing")})
    if "--fp32-engine" in sys.argv:
        out["fp32_engine"] = fp32_engine(cs)
    if "--fp32" in sys.argv:
        print(json.dumps(out), flush=True)
        return 0
    out["fwd"] = [
        fwd_case(cs, gen, "main", 2, 2048, True),
        fwd_case(cs, gen, "main_softcap", 2, 2048, True, softcap=50.0),
        fwd_case(cs, gen, "causal_s8192", 1, 8192, True),
        fwd_case(cs, gen, "gemma2_window", 1, 8192, True, widths=(16, 8, 256), window=4096,
                 softcap=50.0, q_scale=cs.CAP_Q_SCALE),
    ]
    for name, seen, n_new, N, B, kind in PAGED:
        r = cs._paged_case(gen, name, seen, n_new, N=N, B=B, **paged_kw(cs, kind))
        out["paged"].append({k: r.get(k) for k in ("case", "path", "ms", "plain_ms",
                                                    "bound_ms", "bound_by", "row_rel_err",
                                                    "rounding_row_rel_err",
                                                    "staged_row_rel_err")})
    for name, seen, B, kind in DECODE:
        for int8 in (False, True):
            r = cs._paged_case(gen, name + ("_int8" if int8 else ""), DECODE_SEEN[seen],
                               [1] * 8, N=1, B=B, graph=True, int8=int8, **paged_kw(cs, kind))
            out["paged"].append({k: r.get(k) for k in (
                "case", "path", "ms", "plain_ms", "bound_ms", "bound_by", "row_rel_err",
                "rounding_row_rel_err", "staged_row_rel_err", "timing")})
    if "--flex" in sys.argv:
        for name, seen, n_new, N, B, kind in PAGED[:2]:
            kw = paged_kw(cs, kind)
            out["paged"].append({
                "case": name + " (flex_attention, keys gathered contiguous; not K4)",
                "ms": flex_chunk(cs, gen, seen[0], n_new[0], kw["widths"], kw.get("window"),
                                 kw.get("softcap"), kw.get("q_scale", 1.0))})
            cs.free_memory()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
