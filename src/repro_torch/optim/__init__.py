from .optimizers import Optimizer, adamw, sgd
from .schedule import constant, cosine, linear_warmup_cosine

__all__ = ["Optimizer", "sgd", "adamw", "constant", "cosine",
           "linear_warmup_cosine"]
