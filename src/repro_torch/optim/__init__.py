from .optimizers import (adafactor_init, adafactor_update,  # noqa: F401
                         adamw_init, adamw_update, clip_by_global_norm,
                         global_norm, make_optimizer)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
