from repro_torch.runtime.train_loop import (TrainOptions, init_state,
                                            make_train_step, train)

__all__ = ["TrainOptions", "init_state", "make_train_step", "train"]
