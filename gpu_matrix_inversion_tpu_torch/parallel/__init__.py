"""Multi-device execution: meshes over a ``torch.distributed`` world and
panel-sharded inversion (port of ``gpu_matrix_inversion_tpu/parallel``).

The augmented system is column-sharded over a mesh axis, one rank per
device (NCCL on cards, gloo ranks on the CPU), with one collective per
panel group and the trailing updates as local GEMMs
(``sharded.py``); ``launch.spawn_ranks`` starts a world on one host.
"""

from gpu_matrix_inversion_tpu_torch.parallel.launch import (
    dryrun_multichip,
    spawn_ranks,
)
from gpu_matrix_inversion_tpu_torch.parallel.mesh import make_device_mesh
from gpu_matrix_inversion_tpu_torch.parallel.sharded import (
    sharded_blocked_inverse,
    sharded_batched_inverse,
)

__all__ = [
    "make_device_mesh",
    "sharded_blocked_inverse",
    "sharded_batched_inverse",
    "spawn_ranks",
    "dryrun_multichip",
]
