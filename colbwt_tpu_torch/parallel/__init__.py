from colbwt_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_index,
    shard_reads,
)
from colbwt_tpu_torch.parallel.query_sharded import (  # noqa: F401
    query_batch_sharded,
)
from colbwt_tpu_torch.parallel.query_sharded_pos import (  # noqa: F401
    query_batch_sharded_pos,
    shard_pos_tables,
)
from colbwt_tpu_torch.parallel.router import (  # noqa: F401
    choose_sharded_engine,
    query_batch_sharded_auto,
)
