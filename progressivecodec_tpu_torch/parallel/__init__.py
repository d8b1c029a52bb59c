"""Multi-process and multi-card execution of the port on torch.distributed:
start-up and collectives (`distributed`), the (data, model) mesh and the
parameter rule (`mesh`), the sharded PCT1-G coder (`sharded_coder`), width
tiling with halo exchange (`tiling`) and the sharded train step
(`sharding`).  Counterpart of `progressivecodec_tpu/parallel/`."""

from progressivecodec_tpu_torch.parallel.mesh import make_mesh, shard_params_rule
from progressivecodec_tpu_torch.parallel.sharding import make_sharded_train_step

__all__ = ["make_mesh", "shard_params_rule", "make_sharded_train_step"]
