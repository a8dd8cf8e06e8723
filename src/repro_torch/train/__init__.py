"""Training support: AdamW and ``.npz`` checkpoints.

Counterpart of ``repro/train/``."""
