from .optimizers import Optimizer, sgd
from .schedule import constant, cosine, linear_warmup_cosine

__all__ = ["Optimizer", "sgd", "constant", "cosine", "linear_warmup_cosine"]
