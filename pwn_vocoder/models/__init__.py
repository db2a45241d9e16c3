from pwn_vocoder.models.modules import (  # noqa: F401
    gated_layer_xla,
    wavenet_stack,
)
from pwn_vocoder.models.teacher import TeacherWaveNet  # noqa: F401
from pwn_vocoder.models.student import StudentIAF  # noqa: F401
