from repro_torch.train.serve_loop import greedy_decode, make_serve_fns
from repro_torch.train.train_loop import TrainState, make_train_step, train_init

__all__ = ["TrainState", "greedy_decode", "make_serve_fns", "make_train_step",
           "train_init"]
