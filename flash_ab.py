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
                             [--k8-limits=N,N,...]

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
``SplashTables.build`` takes ``limit``).
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

    def timed(batch):
        before = [getattr(pa, c) for c in counters]
        torch.cuda.synchronize()
        t = time.monotonic()
        out = inner(batch)
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
