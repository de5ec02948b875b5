from repro_torch.training.checkpoint import (  # noqa: F401
    CheckpointManager,
    restore,
    restore_sharded,
    save,
)
from repro_torch.training.compress import (  # noqa: F401
    compress,
    decompress,
    init_error_state,
)
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    cosine_schedule,
    init_opt_state,
    opt_state_specs,
    wsd_schedule,
)
from repro_torch.training.trainstep import (  # noqa: F401
    TrainStepConfig,
    chunked_ce_loss,
    make_loss_fn,
    make_train_step,
)
