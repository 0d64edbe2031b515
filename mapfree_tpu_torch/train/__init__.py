from mapfree_tpu_torch.train.state import (
    TrainState,
    clip_by_global_norm_,
    init_state,
    make_lr_schedule,
    make_optimizer,
    make_predict_step,
    make_train_step,
    make_val_step,
)
from mapfree_tpu_torch.train.loop import (
    CheckpointManager,
    ScalarLogger,
    aggregate_validation,
    check_finite_or_die,
    run_validation,
)
