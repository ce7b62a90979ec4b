"""repro_torch.optim: AdamW (port of ``repro.optim``)."""
