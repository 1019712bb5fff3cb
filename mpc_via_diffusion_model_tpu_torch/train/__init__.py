from .regression import fit_mlp_regression
from .trainer import (EarlyStopper, Optimizer, ParamLayout, TrainState, Trainer, diffusion_loss,
                      load_checkpoint, make_custom_train_step, make_eval_step, make_optimizer,
                      make_scanned_train_steps, make_train_step, save_checkpoint, value_and_grad)

__all__ = ["EarlyStopper", "Optimizer", "ParamLayout", "TrainState", "Trainer", "diffusion_loss",
           "fit_mlp_regression", "load_checkpoint", "make_custom_train_step", "make_eval_step",
           "make_optimizer", "make_scanned_train_steps", "make_train_step", "save_checkpoint",
           "value_and_grad"]
