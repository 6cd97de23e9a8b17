from luminoth_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_from_env,
    sync_state_from_chief,
    worker_env,
)
from luminoth_tpu_torch.parallel.mesh import (  # noqa: F401
    is_chief,
    shard_batch,
    world,
)
