from goliath_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    make_sharded_train_step,
    shard_batch,
)
