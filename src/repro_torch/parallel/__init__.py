"""repro_torch.parallel: the fabric meshes, collectives and the rank
launcher of the sharded executor on ``torch.distributed`` (port of the
fabric part of ``repro.parallel``)."""
