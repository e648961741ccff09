#!/usr/bin/env python3
"""A/B of the flash kernels of one source tree at the training shape on a
CUDA GPU: K2's dq and dk/dv, per head and folded, in fp16 over three
seeds (the row error against the plain version and each one's distance
from the exact fp64 value), then K1/K2 in bf16 at the main shape with and
without softcap 50, each pass's time beside SDPA's (or flex_attention's).

    python3 flash_ab.py TREE TAG

TREE is the root of a checkout (this one: ``.``; another commit: unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists,
e.g. ``build/parent``); its own ``chip_smoke.py`` cases and kernels run,
its library built under it. Prints one JSON line tagged TAG. To compare
two commits on one card, run them in turns in one command: parent,
change, change, parent.
"""

import json
import os
import sys
import time


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
           "cases": []}
    for seed in range(3):
        for layout in ("per_head", "folded"):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(100 + seed)
            r = cs._flash_case(gen, "main_fp16", 2, 2048, True, torch.float16, layout=layout)
            out["cases"].append({"seed": 100 + seed, "layout": layout, "dtype": "float16",
                                 **{k: {"row_rel_err": r[k]["row_rel_err"], "ms": r[k]["ms"],
                                        "vs_exact": r[k]["vs_exact"]}
                                    for k in ("dq", "dkdv")}})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for name, kw in (("main", {}), ("main_softcap", {"softcap": 50.0})):
        r = cs._flash_case(gen, name, 2, 2048, True, **kw)
        out["cases"].append({"case": name, "dtype": "bfloat16",
                             **{k: {"row_rel_err": r[k]["row_rel_err"], "ms": r[k]["ms"],
                                    "library_ms": r[k]["library_ms"], "vs_exact": r[k]["vs_exact"]}
                                for k in ("fwd", "dq", "dkdv")}})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
