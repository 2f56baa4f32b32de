"""Data-parallel training across processes (``torch.distributed``)."""

from sd_video_gen_tpu_torch.parallel.mesh import (default_mesh_for_batch,
                                                  parse_mesh_spec)
