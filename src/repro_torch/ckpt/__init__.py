"""Checkpoints in the JAX package's format (``.npy`` leaves + manifest)."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    FamilyMismatch, latest_step, manifest_family, read_manifest,
    require_family, restore_checkpoint, save_checkpoint,
)
