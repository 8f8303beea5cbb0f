from .downlink import EF21PDownlink, MarinaPDownlink, make_downlink  # noqa: F401
from .trainer import TrainerConfig, init_state, make_train_step, train_loop  # noqa: F401
