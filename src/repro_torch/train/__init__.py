"""The data-parallel trainer: train-step programs and the loop."""
from .loop import LoopConfig, init_replicated, train
from .step import TrainSettings, build_train_step, opt_state_template

__all__ = ["LoopConfig", "init_replicated", "train", "TrainSettings",
           "build_train_step", "opt_state_template"]
