"""pwn_vocoder — a Parallel WaveNet vocoder framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the public
``andabi/parallel-wavenet-vocoder`` repo (TF-1.x/tensorpack, 2018):

* a **teacher WaveNet** — dilated causal conv stack with a discretized
  mixture-of-logistics (MoL) output head, trained autoregressively by
  teacher forcing on mel-conditioned raw audio,
* a **student IAF** — a stack of inverse-autoregressive flows, distilled
  from the teacher, that synthesizes a full waveform in ONE parallel XLA
  graph execution (no sample-by-sample loop),
* a `lax.scan` fast-generation path with cached conv queues (Fast WaveNet)
  for the teacher's AR sampling,
* data-parallel (+ optional tensor-parallel) scaling over a
  `jax.sharding.Mesh` with XLA collectives (`psum`).

Layer map (SURVEY.md §1, target column):
    T0 XLA           every path plain jax.numpy/lax, compiled by XLA
    T2 utils/dsp     jnp-native STFT/mel (replaces reference librosa layer)
    T3 data/         per-host sharded input pipeline (replaces ZMQ prefetch)
    T4 ops/          causal dilated conv, gated blocks, MoL
    T5 models/       TeacherWaveNet, StudentIAF (plain init/apply)
    T6 config        dataclass presets mirroring the reference "cases"
    T7 cli           train-teacher / distill-student / generate / serve

The reference mount was empty at survey time; behavioral parity targets
come from SURVEY.md §8 (algorithmic spec) and BASELINE.json.
"""

__version__ = "0.1.0"

from pwn_vocoder.config import (  # noqa: F401
    Config,
    DSPConfig,
    MeshConfig,
    StudentConfig,
    TeacherConfig,
    TrainConfig,
    get_config,
    list_configs,
)

# lazy convenience exports (keep `import pwn_vocoder` light: these pull in
# jax model code on first touch only)
_LAZY = {
    "generate_student": "pwn_vocoder.generate",
    "generate_teacher": "pwn_vocoder.generate",
    "stream_student_chunks": "pwn_vocoder.generate",
    "mel_from_wav": "pwn_vocoder.generate",
    "run_teacher_training": "pwn_vocoder.training.loop",
    "run_distillation": "pwn_vocoder.training.loop",
    "run_student_direct_training": "pwn_vocoder.training.loop",
    "load_teacher_params": "pwn_vocoder.training.loop",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pwn_vocoder' has no attribute {name!r}")
