"""Attention-kernel sweep (counterpart of ``tests/perf/run_attn_sweep.py``,
which ``bin/ds_kernel_tune`` drives): time each leg of ``flash_attention``
per implementation on one shape and commit the winners to the autotune
cache (``ops/autotune_cache.py``) that ``ops/kernel_dispatch.py`` reads on
the next call.

    python -m deepspeed_tpu_torch.ops.attn_sweep --batch 1 --seq 8192 \\
        --heads 32 --kv-heads 8 --head-dim 128 --window 4096

Per shape it times
  fwd: pallas (K1), folded (K3), and on the CPU xla (the plain attention);
  bwd: the forward plus the backward with the forward pinned to ``pallas``,
       so that the legs differ only by the backward under test: pallas
       (K2), folded (K3), and on the CPU xla (autograd through the plain
       attention);
each on CUDA events on the card and on the host clock on the CPU, where
the kernel legs run their plain versions. The candidates are
``kernel_dispatch.route_impls`` of the device kind: a card's measured
entries name only the kernels. Entries are keyed on the device kind
(``torch.cuda.get_device_name``, or ``cpu``), so a CPU run never passes
for a card's measurement. The kernels run one tile, so each
implementation is timed once and its entry records the default blocks of
the head dim (``kernel_dispatch.default_blocks``). ``--dry-run`` commits
nothing.
"""

import argparse
import time

import numpy as np
import torch

from . import kernel_dispatch as kd
from .attention import flash_attention
from .autotune_cache import get_cache


def _time(fn, iters: int, device, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``: CUDA events
    on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def sweep_shape(batch, seq, heads, kv_heads, head_dim, dtype, causal, *,
                window=None, softcap=None, iters=10, impls=None, commit=True,
                device=None):
    """Sweep one shape on ``device`` (default: the card); returns ``{leg:
    (winner entry, rows)}`` with rows ``(impl, ms)``, and commits the
    winners unless ``commit`` is false. ``impls`` (default: all the device
    kind's candidates) must be among them."""
    device = torch.device(device or "cuda")
    dtype = getattr(torch, kd.dtype_name(dtype))
    rng = np.random.default_rng(0)
    shp_q, shp_kv = (batch, seq, heads, head_dim), (batch, seq, kv_heads, head_dim)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device=device, dtype=dtype).requires_grad_()
               for s in (shp_q, shp_kv, shp_kv))
    do = torch.from_numpy(rng.standard_normal(shp_q).astype(np.float32)).to(device, dtype)
    kind = kd.device_kind(device)
    sig = kd.make_sig(shp_q, kv_heads, seq, dtype, causal, window, softcap)
    candidates = kd.route_impls(kind)
    impls = tuple(impls or candidates)
    if not set(impls) <= set(candidates):
        raise ValueError(f"attn_sweep: device kind {kind!r} picks among {candidates}, "
                         f"not {impls}")
    opts = dict(causal=causal, window=window, softcap=softcap)

    def fwd_fn(impl):
        def run():
            with torch.no_grad():
                flash_attention(q, k, v, impl_fwd=impl, impl_bwd=impl, **opts)
        return run

    def bwd_fn(impl):
        def run():
            out = flash_attention(q, k, v, impl_fwd=kd.IMPL_PALLAS, impl_bwd=impl, **opts)
            torch.autograd.grad(out, (q, k, v), do)
        return run

    bq, bk = kd.default_blocks(head_dim)
    results = {}
    for leg, make in (("fwd", fwd_fn), ("bwd", bwd_fn)):
        rows = []
        for impl in impls:
            ms = _time(make(impl), iters, device)
            rows.append((impl, ms))
            print(f"  {leg} {impl: <8} {ms: >9.4f} ms", flush=True)
        impl, ms = min(rows, key=lambda r: r[1])
        entry = {"impl": impl, "block_q": bq, "block_k": bk, "ms": round(ms, 4),
                 "note": f"attn_sweep iters={iters}"}
        results[leg] = (entry, rows)
        if commit:
            get_cache().commit(kd.signature(leg, sig, kind), entry)
        print(f"  {leg} winner: {impl} ({ms:.4f} ms)"
              f"{' -> cache' if commit else ''}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Time the attention legs per implementation on one shape; "
                    "commit the winners to the autotune cache")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=None, help="default: --heads (MHA)")
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--no-causal", dest="causal", action="store_false")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--softcap", type=float, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impls", default=None,
                    help="comma-separated subset of the device kind's candidates: "
                         "pallas,folded on a card, xla,pallas,folded on the CPU "
                         "(default: all of them)")
    ap.add_argument("--device", default=None,
                    help="default: cuda; 'cpu' times the plain versions")
    ap.add_argument("--dry-run", action="store_true", help="time everything, commit nothing")
    args = ap.parse_args(argv)

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("attn_sweep: no CUDA device; pass --device cpu to time the plain "
              "versions (keyed under device kind 'cpu')")
        return 2
    kv = args.kv_heads if args.kv_heads is not None else args.heads
    impls = tuple(args.impls.split(",")) if args.impls else None
    print(f"attn sweep: b{args.batch} s{args.seq} h{args.heads} kv{kv} "
          f"d{args.head_dim} {args.dtype} causal={args.causal} window={args.window} "
          f"softcap={args.softcap} device_kind={kd.device_kind(device)!r} "
          f"cache={get_cache().path}", flush=True)
    sweep_shape(args.batch, args.seq, args.heads, kv, args.head_dim, args.dtype,
                args.causal, window=args.window, softcap=args.softcap,
                iters=args.iters, impls=impls,
                commit=not args.dry_run, device=device)
    if not args.dry_run:
        print(f"table now: {get_cache().source_description()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
