from .engine import (AsyncCheckpointEngine, CheckpointCorruptionError,  # noqa: F401
                     CheckpointEngine, COMMIT_MARKER_FILE, MANIFEST_FILE, ShardedReader,
                     TorchCheckpointEngine, find_latest_valid_checkpoint, prune_checkpoints,
                     quarantine_checkpoint, read_latest_tag, scan_tags, verify_checkpoint,
                     write_latest_tag, write_manifest)
from .universal import ds_to_universal, load_universal  # noqa: F401
from .zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,  # noqa: F401
                           get_fp32_state_dict_from_zero_checkpoint)
