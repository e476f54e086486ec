"""Mesh, shardings and process groups (``mesh.py``): the counterpart of
the JAX package's ``parallel`` package, on ``torch.distributed``."""

from .mesh import (  # noqa: F401
    batch_sharding,
    data_axis_size,
    get_mesh,
    make_sharded_train_step,
    param_shardings,
    place_train_state,
    replicated,
    run_ranks,
    shard_batch,
)
