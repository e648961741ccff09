"""Build and load the port's CUDA kernels (counterpart of
``deepspeed_tpu/ops/jit_build.py``).

Every ``csrc/*.cu`` source has a plain C interface (no PyTorch headers).
One ``nvcc -c`` per source runs, all at once, and one more links the
objects into a shared library (``python3 -m deepspeed_tpu_torch.ops._build``
times this against one ``nvcc`` call for all sources). The
library lands in ``build/deepspeed_tpu_torch/<hash>/`` beside the package
(a directory ``.gitignore`` lists), keyed by a hash of the sources and the
flags, and is loaded with ``ctypes``. The build runs at the first kernel
launch, never at import: hosts without ``nvcc`` import this module freely.

Calling convention of every entry point: pointers and the CUDA stream are
``void*`` (``ctypes.c_void_p``, from ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``), and the function returns
``cudaGetLastError()`` right after its launch; :func:`check` raises on a
non-zero code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "--resource-usage")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures (see csrc/*.cu); all return int (a cudaError_t, but for
# dstt_flash_wgmma_smem, dstt_paged_wgmma_smem, dstt_paged_decode_smem,
# dstt_paged_f32_smem, dstt_paged_wgmma_min_rows and
# dstt_paged_f32_chunk_min_rows)
_SIGNATURES = {
    # x, w, out, rows, d, eps, dtype, weight dtype, weight loads (-1 the
    # plan's, 0 before the statistic, 1 after it), stream
    "dstt_rms_norm": (_P, _P, _P, _L, _I, _F, _I, _I, _I, _P),
    # x, w, b, out, rows, d, eps, dtype, weight loads, stream
    "dstt_layer_norm": (_P, _P, _P, _P, _L, _I, _F, _I, _I, _P),
    # stream: an empty kernel, the card's floor for one launch
    "dstt_empty_launch": (_P, ),
    # S, N, H, D, KV, B, page_size, window, q dtype, cache dtype, kernel
    # (-1: the plan's), out: workspace length in fp32 words, out: the
    # kernel it runs (0 CUDA cores, 1 wgmma tiles, 2 decode, 3 fp32 chunk,
    # 4 fp32 decode), out: the pages of each split, out: the keys of each
    # step of a row's running max
    "dstt_paged_attention_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  ctypes.POINTER(_L), ctypes.POINTER(_I),
                                  ctypes.POINTER(_I), ctypes.POINTER(_I)),
    # head width: returns the folded rows from which K4's plan takes the
    # wgmma tiles
    "dstt_paged_wgmma_min_rows": (_I, ),
    # returns the folded rows from which K4's plan takes the fp32 chunk
    # kernel
    "dstt_paged_f32_chunk_min_rows": (),
    # head width, int8 cache: returns the bytes of dynamic shared memory of
    # that K4 wgmma / decode instance
    "dstt_paged_wgmma_smem": (_I, _I),
    "dstt_paged_decode_smem": (_I, _I),
    # head width, int8 cache, chunk kernel (else the decode kernel), the
    # decode kernel's rows a block: the bytes of dynamic shared memory of
    # that fp32-query instance
    "dstt_paged_f32_smem": (_I, _I, _I, _I),
    # q, cache, cache_scales, slopes, out, block_table, seen, lens, S, N, H,
    # D, KV, B, slots, layer, page_size, window, scale, softcap, q dtype,
    # cache dtype, kernel, workspace, workspace length, stream
    "dstt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _L, _I, _I, _I, _F, _F, _I, _I, _I, _P, _L,
                             _P),
    # x, n, block, dtype, values, scales, stream
    "dstt_quantize_int8": (_P, _L, _I, _I, _P, _P, _P),
    # values, scales, n, block, out, dtype, stream
    "dstt_dequantize_int8": (_P, _P, _L, _I, _P, _I, _P),
    # q, k, v, o, lse, B, S, H, KV, D, scale, causal, window, softcap, dtype,
    # stream (the folded K3 entry point takes the same)
    "dstt_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F,
                       _I, _P),
    "dstt_flash_folded_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                              _I, _F, _I, _P),
    # q, k, v, dO, lse, delta, dq, B, S, H, KV, D, scale, causal, window,
    # softcap, dtype, stream
    "dstt_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _I, _I, _F, _I, _P),
    "dstt_flash_folded_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _F, _I, _I, _F, _I, _P),
    # q, k, v, dO, lse, delta, dk, dv, B, S, H, KV, D, scale, causal, window,
    # softcap, dtype, stream
    "dstt_flash_bwd_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _I, _I, _F, _I, _P),
    "dstt_flash_folded_bwd_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _F, _I, _P),
    # q, k, v, o, lse, plan items, plan entries, items, the most entries of
    # an item, BH, S, D, plan heads, block, scale, dtype, partials
    # (accumulators), partials (max, sum), partial slots, stream
    "dstt_splash_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _I, _P, _P, _I, _P),
    # o, lse, merges, merge rows, BH, S, D, plan heads, dtype, the two
    # partials, partial slots, stream
    "dstt_splash_fwd_merge": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                              _P),
    # q, k, v, dO, lse, delta, dq, the forward plan's items and entries,
    # items, the most entries of an item, BH, S, D, plan heads, block, scale,
    # dtype, partials of dq, partial slots, stream
    "dstt_splash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _F, _I, _P, _I, _P),
    # dq, merges, merge rows, BH, S, D, plan heads, dtype, the partials,
    # partial slots, stream
    "dstt_splash_dq_sum": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P),
    # pass (0 forward, 1 dq, 2 dk/dv), dtype, head width (64 or 128): the
    # bytes of dynamic shared memory of that grouped instance before its
    # item's entries
    "dstt_splash_smem": (_I, _I, _I),
    # q, k, v, dO, lse, delta, dk, dv, the transposed plan's items and
    # entries, items, the most entries of an item, BH, S, D, plan heads,
    # block, scale, dtype, partials of dk and of dv, partial slots, stream
    "dstt_splash_bwd_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _F, _I, _P, _P, _I, _P),
    # dk, dv, merges, merge rows, BH, S, D, plan heads, dtype, the two
    # partials, partial slots, stream
    "dstt_splash_dkdv_sum": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                             _P),
    # pass (0 forward, 1 dq, 2 dk/dv), head width, softcap: returns the
    # bytes of dynamic shared memory of that flash wgmma instance
    "dstt_flash_wgmma_smem": (_I, _I, _I),
    # p, g, m, v, n, lr (fp32 pointer), step (fp32 pointer), skip (byte
    # pointer or null), b1, 1 - b1, log b1, b2, 1 - b2, log b2, eps, weight
    # decay, mode, p dtype, g dtype, stream
    "dstt_adam_step": (_P, _P, _P, _P, _L, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F,
                       _F, _I, _I, _I, _P),
    # p, g, m, n, lr (pointer), skip (pointer or null), b1, 1 - b1, b2,
    # 1 - b2, weight decay, mode, p dtype, g dtype, stream
    "dstt_lion_step": (_P, _P, _P, _L, _P, _P, _F, _F, _F, _F, _F, _I, _I, _I, _P),
    # g, m, v, u, n, step (pointer), skip (pointer or null), b1, 1 - b1,
    # log b1, b2, 1 - b2, log b2, eps, g dtype, stream
    "dstt_lamb_update": (_P, _P, _P, _P, _L, _P, _P, _F, _F, _F, _F, _F, _F, _F,
                         _I, _P),
}

_lock = threading.Lock()
_lib = None
RESOURCE_LOG = "resource_usage.txt"


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the deepspeed_tpu_torch CUDA kernels")


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdstt_kernels.so"


def _run(cmds):
    """Run the commands at once; raise with the output of every one that
    fails; return each one's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n(exit {proc.returncode})\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def _compile(out: Path) -> None:
    """Each source in its own ``nvcc -c`` process, all started together,
    then one link into ``out``. The objects and the library are written
    in a temporary directory beside ``out`` and the library is renamed
    into place, so a concurrent or interrupted build never leaves a torn
    file. ptxas's report of every kernel's registers and spills
    (``--resource-usage``) goes to ``resource_usage.txt`` beside it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        objs = [work / (src.stem + ".o") for src in sources()]
        logs = _run([[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources(), objs)])
        (out.parent / RESOURCE_LOG).write_text("".join(
            f"# {src.name}\n{log}" for src, log in zip(sources(), logs)))
        tmp = work / out.name
        _run([[nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path."""
    out = library_path()
    if not out.exists():
        _compile(out)
    return out


def lib():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def resource_usage(pattern: str = "") -> list:
    """ptxas's report from the build of this library, one entry per
    kernel whose mangled name contains ``pattern``: ``{"kernel":
    demangled name, "registers", "spill_stores", "spill_loads"}`` (bytes
    for the spills; ``"local_bytes"`` where ptxas reports the kernel's
    local memory instead)."""
    import re
    text = (library_path().parent / RESOURCE_LOG).read_text()
    found, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for|Function) "
                      r"'?(_Z\w+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or pattern not in name:
            continue
        entry = found.setdefault(name, {"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line) or re.search(r"REG:(\d+)", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"LOCAL:(\d+)", line)
        if m:
            entry["local_bytes"] = int(m.group(1))
    entries = list(found.values())
    filt = Path(nvcc_path()).parent / "cu++filt"
    if entries and filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(e["kernel"] for e in entries),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for e, demangled in zip(entries, names):
            e["kernel"] = demangled.strip() or e["kernel"]
    return entries


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


# kernel dtype codes (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "float16": 3}


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel does not take dtype {dtype}")
    return DTYPE_CODES[name]


def _time_builds(rounds: int = 2) -> dict:
    """Seconds of the parallel build above and of one ``nvcc`` call that
    compiles and links every source, alternated ``rounds`` times, each into
    a throwaway directory."""
    import json
    import time
    times = {"parallel_s": [], "one_call_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(rounds):
            for key in times:
                out = Path(tmp) / f"{key}{i}" / "libdstt_kernels.so"
                t = time.monotonic()
                if key == "parallel_s":
                    _compile(out)
                else:
                    out.parent.mkdir(parents=True)
                    _run([[nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(out),
                           *map(str, sources())]])
                times[key].append(time.monotonic() - t)
    print(json.dumps({"sources": [s.name for s in sources()], **times}), flush=True)
    return times


if __name__ == "__main__":
    # python3 -m deepspeed_tpu_torch.ops._build: time the two ways to build
    _time_builds()
