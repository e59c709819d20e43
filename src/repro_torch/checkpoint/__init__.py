"""Checkpoint store of the port (the reference's on-disk format)."""
from repro_torch.checkpoint.store import load_metadata, restore, save

__all__ = ["save", "restore", "load_metadata"]
