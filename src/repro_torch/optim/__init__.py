from repro_torch.optim.optimizers import Optimizer, adam, adamw, \
    init_opt_state, sgd

__all__ = ["Optimizer", "adam", "adamw", "init_opt_state", "sgd"]
