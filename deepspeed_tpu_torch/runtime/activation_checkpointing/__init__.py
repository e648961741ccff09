from . import checkpointing
