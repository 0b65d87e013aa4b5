"""Crash-recovery checkpoints of the port: ``store`` writes and reads
tensor trees atomically through ``torch.save`` / ``torch.load(
weights_only=True)``; ``fl_state`` saves and restores a whole
``FedSAEServer`` so a resumed run is bitwise the uninterrupted one."""
from repro_torch.checkpoint.fl_state import (checkpoint_path,  # noqa: F401
                                             latest_checkpoint,
                                             list_checkpoints,
                                             restore_server_state,
                                             save_server_state)
from repro_torch.checkpoint.store import (load_checkpoint,  # noqa: F401
                                          save_checkpoint)
