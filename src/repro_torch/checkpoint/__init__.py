"""Flat-key ``.npz`` checkpoints of param and optimizer trees (the port
of ``repro.checkpoint``)."""
from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
