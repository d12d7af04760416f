"""The multi-device layer: a device mesh over the ranks of a
``torch.distributed`` process group (``mesh``), and the port's own dry run
of the layer over spawned ranks (``dryrun``, imported on its own)."""

from .mesh import (
    SITE_AXIS,
    VAR_AXIS,
    shard_sites,
    sharded_first_eof,
    sharded_pairwise_corr,
    sharded_rotation_apply,
    site_mesh,
    site_sharding,
)
