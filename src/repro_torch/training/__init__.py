from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.schedule import cosine_schedule, wsd_schedule
from repro_torch.training.train_loop import TrainConfig, init_train_state, make_train_step

__all__ = [
    "AdamWConfig",
    "TrainConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "init_train_state",
    "make_train_step",
    "wsd_schedule",
]
