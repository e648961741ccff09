"""Reference CLI name: ``python -m deepspeed_tpu_torch.checkpoint.ds_to_universal
<ckpt> <out>`` (reference ``deepspeed/checkpoint/ds_to_universal.py:469
main``), forwarding to ``universal.py``."""

from .universal import main

if __name__ == "__main__":
    raise SystemExit(main())
