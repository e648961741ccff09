"""Universal checkpoint: any-to-any parallelism conversion (port of
``deepspeed_tpu/checkpoint/universal.py``; reference
``deepspeed/checkpoint/ds_to_universal.py`` and
``universal_checkpoint.py:22 load_hp_checkpoint_state``).

The layout is the JAX package's, file for file, so that a directory
written by either package loads into the other:

    <out>/zero/<param.path>/fp32.npy
    <out>/zero/<param.path>/exp_avg.npy       (with Adam-family state)
    <out>/zero/<param.path>/exp_avg_sq.npy
    <out>/universal_meta.json                 {step, params, has_optim_states, source}

``<param.path>`` is the parameter's path in the JAX param tree, dotted
(``model.layers_0.self_attn.q_proj.kernel``): the port's names map onto it
through ``models/convert.py universal_name``. The port's Adam, AdamW and
LAMB keep their first and second moments as the optimizer's ``m`` and
``v``; they become ``exp_avg`` and ``exp_avg_sq`` (JAX's ``mu`` and
``nu``). ``ds_to_universal`` reads a checkpoint of the port's engine at any
world and stage (``engine.ShardedReader``); the engine's
``load_universal_checkpoint`` reads the layout back.
"""

import json
import logging
import os
import shutil
from typing import Dict

import numpy as np

from ..models.convert import universal_name
from .engine import ShardedReader, read_host_state

logger = logging.getLogger(__name__)

MOMENTS = {"optimizer.m": "exp_avg.npy", "optimizer.v": "exp_avg_sq.npy"}


def ds_to_universal(ckpt_path: str, output_dir: str) -> str:
    """Convert a checkpoint tag directory saved by the port's
    ``save_checkpoint`` to the universal layout (reference
    ds_to_universal.py:469 main)."""
    reader = ShardedReader(ckpt_path)
    host_state = read_host_state(ckpt_path)
    zero_dir = os.path.join(output_dir, "zero")
    if os.path.exists(zero_dir):
        shutil.rmtree(zero_dir)
    os.makedirs(zero_dir)
    moments = all(reader.has(k) for k in MOMENTS)
    paths = {}
    for name in reader.shapes:
        path = universal_name(name)
        paths[name] = path
        pdir = os.path.join(zero_dir, path)
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, "fp32.npy"), reader.full("fp32", name).float().numpy())
        if moments:
            for kind, fname in MOMENTS.items():
                np.save(os.path.join(pdir, fname), reader.full(kind, name).float().numpy())
    meta = {"step": int(host_state.get("global_steps", 0)) if host_state else 0,
            "params": sorted(paths.values()),
            "has_optim_states": moments,
            "source": os.path.abspath(ckpt_path)}
    with open(os.path.join(output_dir, "universal_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info(f"universal checkpoint written: {output_dir} ({len(paths)} params)")
    return output_dir


def load_universal(universal_dir: str, fname: str = "fp32.npy") -> Dict[str, np.ndarray]:
    """One fragment kind of every parameter: ``{dotted.path: array}``."""
    with open(os.path.join(universal_dir, "universal_meta.json")) as f:
        meta = json.load(f)
    out = {}
    for name in meta["params"]:
        path = os.path.join(universal_dir, "zero", name, fname)
        if os.path.exists(path):
            out[name] = np.load(path)
    return out


def read_universal_meta(universal_dir: str) -> Dict:
    with open(os.path.join(universal_dir, "universal_meta.json")) as f:
        return json.load(f)


def main(argv=None):
    """CLI: ``python -m deepspeed_tpu_torch.checkpoint.universal <ckpt> <out>``."""
    import argparse
    ap = argparse.ArgumentParser(description="universal checkpoint converter")
    ap.add_argument("input_folder", help="engine checkpoint dir (a tag dir)")
    ap.add_argument("output_folder", help="universal checkpoint output dir")
    args = ap.parse_args(argv)
    ds_to_universal(args.input_folder, args.output_folder)


if __name__ == "__main__":
    main()
