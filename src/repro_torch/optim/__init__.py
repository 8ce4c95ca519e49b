from repro_torch.optim.optimizers import (Optimizer, adamw, make_optimizer,
                                          sgd, sgd_momentum)
from repro_torch.optim.schedules import (constant, pegasos_schedule,
                                         warmup_cosine)

__all__ = ["Optimizer", "sgd", "sgd_momentum", "adamw", "make_optimizer",
           "warmup_cosine", "constant", "pegasos_schedule"]
