"""Data- and tensor-parallel runs across processes (``torch.distributed``):
the process layout (``mesh``), the sharding rules (``sharding``) and the
collectives of the sharded modules (``constrain``)."""

from sd_video_gen_tpu_torch.parallel.mesh import (default_mesh_for_batch,
                                                  make_layout,
                                                  parse_mesh_spec)
