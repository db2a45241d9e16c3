from pwn_vocoder.training.common import (  # noqa: F401
    TrainState,
    make_optimizer,
)
from pwn_vocoder.training.teacher import make_teacher_train_step  # noqa: F401
from pwn_vocoder.training.distill import (  # noqa: F401
    distillation_losses,
    make_distill_train_step,
)
