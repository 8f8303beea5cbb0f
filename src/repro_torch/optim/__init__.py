from .optimizers import adamw_init, adamw_update, sgd_init, sgd_update, Optimizer, make_optimizer  # noqa: F401
from .schedules import constant_lr, cosine_warmup, make_schedule  # noqa: F401
