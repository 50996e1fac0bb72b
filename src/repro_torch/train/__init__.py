from .step import TrainStepBundle, make_train_step, make_train_state_specs

__all__ = ["TrainStepBundle", "make_train_step", "make_train_state_specs"]
