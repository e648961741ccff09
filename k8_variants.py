#!/usr/bin/env python3
"""Variants of K8's grouped forward and dk/dv kernels on a CUDA GPU, to
find what bounds them. A variant is ``csrc/splash_grouped.cuh`` with a few
lines replaced, built alone (bf16 at head width 64, blocks 16 and 64) into
``build/k8_variants/``, and timed through the port's wrappers at
chip_smoke.py's ``SPLASH_SHAPE`` under its four layouts (a CUDA graph of 20
calls), in turns (every variant, then every variant again in reverse),
each beside its row error against the plain version. Probes that skip work
give wrong outputs by design.

    python3 k8_variants.py [NAME ...]        (every variant by default)

Variants: ``base`` (the source as it is); ``staging_only`` (no products:
the ring's copies and barriers alone); ``products_only`` (no copies after
the ring's first stages: the products on stale tiles); forward probes
``no_exp``, ``no_pv``, ``no_s``; ``ring2`` and ``ring4`` (ring depth);
``group128`` (128-row groups of 8 warps, with the plans' groups to match)
and its ``group128_staging_only`` and ``group128_products_only``. Prints
one JSON line.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import time

HEADER = "deepspeed_tpu_torch/csrc/splash_grouped.cuh"
OUT = "build/k8_variants"

_GROUP = "constexpr int kGroupRows = 64;"
_RING = "  return sizeof(T) * DMAX > 256 ? 2 : 3;"
_BLOCKS = "  return DMAX > 64 ? 1 : P == kPassDkdv ? 3 * 64 / kGroupRows : 4 * 64 / kGroupRows;"
_SKIP = "    if (act == 0 || wrow < 0) continue;"
_LOAD = "    if (t >= nst) return;"
_EXP = "        s[c][j][e] = exp2_ftz(fmaf(s[c][j][e], scale2, -mu[e >> 1]));"
_PV = "    if (on(c)) pn16<T, DMAX, LD>(acc, s[c], Vs + c * kWarpRows * LD, lane);"
_S = "    nt16<T, DMAX, LD>(s[c], qa, Ks + c * kWarpRows * LD, lane);"

_STAGING = (_SKIP, _SKIP.replace("wrow < 0)", "wrow < 0 || true)"))
_PRODUCTS = (_LOAD, _LOAD.replace("t >= nst)", "t >= nst || t >= NS - 1)"))
_G128 = (_GROUP, _GROUP.replace("64", "128"))

# name: (group rows, [(text, replacement), ...])
VARIANTS = {
    "base": (64, []),
    "staging_only": (64, [_STAGING]),
    "products_only": (64, [_PRODUCTS]),
    "no_exp": (64, [(_EXP, _EXP.replace("exp2_ftz(", "0.001f * ("))]),
    "no_pv": (64, [(_PV, _PV.replace("if (on(c))", "if (on(c) && lane > 31)"))]),
    "no_s": (64, [(_S, "    for (int j = 0; j < 2; ++j)\n      for (int e = 0; e < 4; ++e)"
                       " s[c][j][e] = 0.01f * (j + e + c);")]),
    "ring2": (64, [(_RING, _RING.replace(": 3;", ": 2;"))]),
    "ring4": (64, [(_RING, _RING.replace(": 3;", ": 4;")),
                   (_BLOCKS, _BLOCKS.replace("4 * 64", "2 * 64").replace("3 * 64", "2 * 64"))]),
    "group128": (128, [_G128]),
    "group128_staging_only": (128, [_G128, _STAGING]),
    "group128_products_only": (128, [_G128, _PRODUCTS]),
}

HARNESS = r'''
#include VARIANT_HEADER
namespace dstt { namespace splash {
cudaError_t launch_fwd_f32(const GArgs&, int, cudaStream_t) { return cudaErrorInvalidValue; }
cudaError_t launch_dkdv_f32(const GArgs&, int, cudaStream_t) { return cudaErrorInvalidValue; }
}}
using namespace dstt::splash;
template <int P>
static int go(GArgs a, int block, int dtype, void* stream) {
  if (!grouped_ok(a, P) || dtype != dstt::kBFloat16 || a.D > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (block == 16) return (int)launch_grouped<P, __nv_bfloat16, 16, 64>(a, s);
  if (block == 64) return (int)launch_grouped<P, __nv_bfloat16, 64, 64>(a, s);
  return (int)cudaErrorInvalidValue;
}
extern "C" int dstt_splash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               const void* items, const void* entries, int n_items, int cap,
                               int BH, int S, int D, int Lh, int block, float scale, int dtype,
                               void* ws, void* ws2, int n_parts, void* stream) {
  GArgs a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, (float*)lse, (const int*)items,
          (const int*)entries, (float*)ws, (float*)ws2, n_items, n_parts, 0, BH, S, D, Lh, cap,
          scale};
  return go<kPassFwd>(a, block, dtype, stream);
}
extern "C" int dstt_splash_fwd_merge(void* o, void* lse, const void* merges, int n_merges,
                                     int BH, int S, int D, int Lh, int dtype, void* ws,
                                     void* ws2, int n_parts, void* stream) {
  GArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
          (const int*)merges, nullptr, (float*)ws, (float*)ws2, n_merges, n_parts, 0, BH, S, D,
          Lh, 0, 0.f};
  return run_second_pass<kPassFwd>(a, dtype, stream);
}
extern "C" int dstt_splash_bwd_dkdv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* items, const void* entries,
                                    int n_items, int cap, int BH, int S, int D, int Lh,
                                    int block, float scale, int dtype, void* ws, void* ws2,
                                    int n_parts, void* stream) {
  GArgs a{q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, nullptr,
          (const int*)items, (const int*)entries, (float*)ws, (float*)ws2, n_items, n_parts, 0,
          BH, S, D, Lh, cap, scale};
  return go<kPassDkdv>(a, block, dtype, stream);
}
extern "C" int dstt_splash_dkdv_sum(void* dk, void* dv, const void* merges, int n_merges,
                                    int BH, int S, int D, int Lh, int dtype, void* ws,
                                    void* ws2, int n_parts, void* stream) {
  GArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dk, dv, nullptr,
          (const int*)merges, nullptr, (float*)ws, (float*)ws2, n_merges, n_parts, 0, BH, S, D,
          Lh, 0, 0.f};
  return run_second_pass<kPassDkdv>(a, dtype, stream);
}
'''
ENTRY_POINTS = ("dstt_splash_fwd", "dstt_splash_fwd_merge", "dstt_splash_bwd_dkdv",
                "dstt_splash_dkdv_sum")


def build(names):
    """Each variant's library, all nvcc runs at once; ptxas's register
    counts of each."""
    from deepspeed_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "harness.cu"), "w") as f:
        f.write(HARNESS)
    source = open(HEADER).read()
    procs = []
    for name in names:
        text = source
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise SystemExit(f"k8_variants: {name}: {old!r} is not in {HEADER}")
            text = text.replace(old, new)
        header = os.path.abspath(os.path.join(OUT, f"{name}.cuh"))
        with open(header, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
               f"-I{os.path.abspath(os.path.dirname(HEADER))}",
               f'-DVARIANT_HEADER="{header}"', "-o", os.path.join(OUT, f"{name}.so"),
               os.path.join(OUT, "harness.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    registers = {}
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k8_variants: {name} failed to build:\n{out}")
        registers[name] = sorted({int(n) for n in re.findall(r"Used (\d+) registers", out)})
    return registers


def load(name):
    from deepspeed_tpu_torch.ops import _build
    handle = ctypes.CDLL(os.path.abspath(os.path.join(OUT, f"{name}.so")))

    class Lib:
        pass

    lib = Lib()
    for entry in ENTRY_POINTS:
        fn = getattr(handle, entry)
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
        setattr(lib, entry, fn)
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k8_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.attention import attention_delta
    from deepspeed_tpu_torch.ops.sparse_attention import splash as sp
    names = sys.argv[1:] or list(VARIANTS)
    t = time.monotonic()
    registers = build(names)
    out = {"gpu": cs.gpu_identity(), "build_s": time.monotonic() - t, "registers": registers,
           "times": {}}
    B, H, S, D = (cs.SPLASH_SHAPE[k] for k in ("B", "H", "S", "D"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    floor = 2.0 ** -16 / cs.FLASH_ROW_TOL["bfloat16"]
    default_rows = sp.GROUP_ROWS
    cases = []
    for case, config, block in cs.SPLASH_LAYOUTS:
        _, layout = cs.splash_layout(config, block)
        tables = {}
        for rows in {VARIANTS[n][0] for n in names}:
            sp.GROUP_ROWS, sp.ITEM_INTS = rows, 4 + rows // sp.WARP_ROWS
            tables[rows] = sp.SplashTables.build(layout, block, "cuda")
        q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o_ref, lse_ref = sp.splash_attention_fwd_reference(q, k, v, layout, block)
        args = (q, k, v, do, lse_ref, attention_delta(o_ref, do))
        cases.append((case, tables, args, o_ref,
                      sp.splash_attention_bwd_dkdv_reference(*args, layout, block)))
    for name in names + names[::-1]:
        lib, rows = load(name), VARIANTS[name][0]
        _build.lib = lambda lib=lib: lib
        sp.GROUP_ROWS, sp.ITEM_INTS = rows, 4 + rows // sp.WARP_ROWS
        for case, tables, args, o_ref, (dk_ref, dv_ref) in cases:
            tab = tables[rows]
            o, _ = sp.splash_attention_fwd(*args[:3], tab)
            dk, dv = sp.splash_attention_bwd_dkdv(*args, tab)
            torch.cuda.synchronize()
            out["times"].setdefault(name, {}).setdefault(case, []).append({
                "fwd_ms": cs.graph_time_ms(lambda: sp.splash_attention_fwd(*args[:3], tab)),
                "dkdv_ms": cs.graph_time_ms(lambda: sp.splash_attention_bwd_dkdv(*args, tab)),
                "fwd_row_rel_err": cs.row_rel_err(o, o_ref, floor),
                "dkdv_row_rel_err": max(cs.row_rel_err(dk, dk_ref, floor),
                                        cs.row_rel_err(dv, dv_ref, floor))})
    sp.GROUP_ROWS, sp.ITEM_INTS = default_rows, 4 + default_rows // sp.WARP_ROWS
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
