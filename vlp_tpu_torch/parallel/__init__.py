"""Data parallelism on ``torch.distributed``: the process group and its
helpers (``dist.py``, in place of the JAX CLIs' ``parallel/mesh.py`` data
axis and ``multihost_utils``) and the data-parallel train step
(``dp_step.py``, the counterpart of ``pjit_step.make_shard_map_step``)."""

from vlp_tpu_torch.parallel.dist import Dist, from_cli, init

__all__ = ["Dist", "from_cli", "init"]
