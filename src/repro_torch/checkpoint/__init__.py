"""Checkpointing of the port (``repro.checkpoint``): the store behind the
adaptive engine's resumable runs."""
from .store import (CheckpointError, CheckpointIntegrityError,
                    CheckpointLayoutError, CheckpointManager,
                    CheckpointSchemaError, install_publish_fault_hook,
                    latest_step, restore, restore_arrays, save)

__all__ = ["CheckpointError", "CheckpointIntegrityError",
           "CheckpointLayoutError", "CheckpointManager",
           "CheckpointSchemaError", "install_publish_fault_hook",
           "latest_step", "restore", "restore_arrays", "save"]
