from repro_torch.runtime.train_loop import (AdaptiveController,
                                            AdaptiveOptions, TrainOptions,
                                            init_state, make_train_step,
                                            train)

__all__ = ["AdaptiveController", "AdaptiveOptions", "TrainOptions",
           "init_state", "make_train_step", "train"]
