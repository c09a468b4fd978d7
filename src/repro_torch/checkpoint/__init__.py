"""Manifest-committed checkpoints of the port, in the reference package's
on-disk format (:mod:`.ckpt`)."""
from .ckpt import (AsyncCheckpointer, CheckpointCorruptError, Snapshot, gc,
                   load, restore, save, unflatten_state)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError", "Snapshot", "gc",
           "load", "restore", "save", "unflatten_state"]
