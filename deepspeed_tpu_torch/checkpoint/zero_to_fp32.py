"""Offline fp32 state dict from a checkpoint of the port's engine (port of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``; reference
``deepspeed/utils/zero_to_fp32.py``): every rank's pieces of the fp32
masters merged into whole parameters, keyed by their dotted JAX tree paths
as the JAX script keys them, and dumped to one ``.npz``."""

import logging
import os
from typing import Dict, Optional

import numpy as np

from ..models.convert import universal_name
from .engine import ShardedReader, read_latest_tag

logger = logging.getLogger(__name__)


def _resolve_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    if tag is None:
        tag = read_latest_tag(checkpoint_dir)
        if tag is None:
            raise ValueError(f"no 'latest' file in {checkpoint_dir}; pass tag explicitly")
    return os.path.join(checkpoint_dir, tag)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """``{dotted.param.path: fp32 array}`` (reference
    ``get_fp32_state_dict_from_zero_checkpoint``)."""
    reader = ShardedReader(_resolve_tag(checkpoint_dir, tag))
    return {universal_name(n): reader.full("fp32", n).float().numpy() for n in reader.shapes}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> str:
    """The whole fp32 parameters as one ``.npz`` (the reference writes
    ``pytorch_model.bin``)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    np.savez(output_file, **sd)
    logger.info(f"saved {len(sd)} fp32 tensors to {output_file}")
    return output_file


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Extract fp32 weights from a checkpoint")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output_file")
    ap.add_argument("-t", "--tag", default=None)
    args = ap.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
