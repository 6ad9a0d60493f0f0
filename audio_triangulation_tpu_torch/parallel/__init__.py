"""Multi-device execution on ``torch.distributed``: meshes, sharded and
explicit-SPMD localization, sharded streaming, data-parallel training."""
