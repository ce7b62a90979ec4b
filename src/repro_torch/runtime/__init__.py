"""repro_torch.runtime: the durable stream runtime and the multi-tenant
engine (port of ``repro.runtime``)."""
