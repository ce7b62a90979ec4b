"""repro_torch.ckpt: crash-consistent checkpoints (port of
``repro.ckpt``)."""
