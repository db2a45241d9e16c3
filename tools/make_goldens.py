#!/usr/bin/env python
"""Generate the frozen golden fixtures for the allclose correctness gate.

SURVEY.md §0/§4: the reference TF implementation was unavailable (empty
mount), so the BASELINE "mel + waveform allclose to reference" gate is
satisfied against SELF-GENERATED goldens whose semantics are pinned by
SURVEY.md §8; this substitution is recorded here and in BASELINE.md.
If a real reference ever appears, regenerate these from its TF graph and
delete this note.

Fixtures (tests/goldens/tiny_v1.npz), all computed in fp32 on CPU:
  clip          — SyntheticTones(seed=123) 4096-sample 16 kHz clip
  mel           — wav_to_mel(clip) under the tiny_teacher DSP config
  teacher_mol   — first 512 steps of teacher MoL params, PRNGKey(0) init
  teacher_nll   — scalar discretized-MoL NLL of the clip
  student_wav   — student(PRNGKey(1) init) transform of fixed z
  z             — the fixed Logistic(0,1) noise, PRNGKey(7)

Regenerate: python tools/make_goldens.py  (only when semantics
intentionally change; bump the version suffix and say why in the commit.)
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pwn_vocoder.config import get_config, override  # noqa: E402
from pwn_vocoder.data import SyntheticTones  # noqa: E402
from pwn_vocoder.models.student import init_student  # noqa: E402
from pwn_vocoder.models.teacher import init_teacher  # noqa: E402
from pwn_vocoder.ops import mol  # noqa: E402
from pwn_vocoder.utils import dsp  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens",
                   "tiny_v1.npz")
OUT_GAUSS = os.path.join(os.path.dirname(__file__), "..", "tests",
                         "goldens", "tiny_gaussian_v1.npz")


def main() -> None:
    cfg = get_config("tiny_teacher")
    clip = SyntheticTones(1, 4096, cfg.dsp.sample_rate, seed=123)[0]
    wav = jnp.asarray(clip)[None]

    x = jnp.clip(dsp.preemphasis(wav, cfg.dsp.preemphasis), -1, 1)
    mel = dsp.mel_spectrogram(x, cfg.dsp)[:, : 4096 // cfg.dsp.hop_length]

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    only_gaussian = "--only-gaussian" in sys.argv
    if only_gaussian:
        print(f"skipped {OUT} (--only-gaussian)")
    else:
        teacher, t_vars = init_teacher(cfg, jax.random.PRNGKey(0))
        t_params = teacher.apply(t_vars, x, mel)
        nll = mol.discretized_mol_loss(
            x, t_params, log_scale_min=cfg.teacher.log_scale_min
        )

        student, s_vars = init_student(cfg, jax.random.PRNGKey(1))
        z = mol.sample_logistic(jax.random.PRNGKey(7), x.shape)
        s_out = student.apply(s_vars, z, mel)

        np.savez_compressed(
            OUT,
            clip=np.asarray(clip, np.float32),
            mel=np.asarray(mel[0], np.float32),
            teacher_mol=np.asarray(t_params[0, :512], np.float32),
            teacher_nll=np.float32(nll),
            z=np.asarray(z[0], np.float32),
            student_wav=np.asarray(s_out.wav[0], np.float32),
            student_log_det=np.asarray(s_out.log_det[0], np.float32),
        )
        print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")

    # Gaussian/ClariNet family fixture (tiny_gaussian_v1.npz): pins the
    # gaussian teacher head, gaussian_nll, and the Gaussian-base student
    # IAF transform on the SAME clip/mel/init keys as the MoL fixture.
    from pwn_vocoder.ops import gaussian  # noqa: E402

    cfg_g = cfg
    for k, v in (("teacher.output", "gaussian"),
                 ("student.base", "gaussian")):
        cfg_g = override(cfg_g, k, v)

    teacher_g, tg_vars = init_teacher(cfg_g, jax.random.PRNGKey(0))
    tg_params = teacher_g.apply(tg_vars, x, mel)
    nll_g = gaussian.gaussian_nll(
        x, tg_params, log_scale_min=cfg_g.teacher.log_scale_min
    )

    student_g, sg_vars = init_student(cfg_g, jax.random.PRNGKey(1))
    z_g = gaussian.sample_normal(jax.random.PRNGKey(7), x.shape)
    sg_out = student_g.apply(sg_vars, z_g, mel)

    np.savez_compressed(
        OUT_GAUSS,
        # clip/mel duplicated from tiny_v1 so the two fixtures cannot
        # silently desynchronize if regenerated separately (a DSP change
        # + --only-gaussian would otherwise leave tiny_v1 stale);
        # tests/test_goldens.py asserts they match
        clip=np.asarray(clip, np.float32),
        mel=np.asarray(mel[0], np.float32),
        teacher_gauss=np.asarray(tg_params[0, :512], np.float32),
        teacher_nll=np.float32(nll_g),
        z=np.asarray(z_g[0], np.float32),
        student_wav=np.asarray(sg_out.wav[0], np.float32),
        student_log_det=np.asarray(sg_out.log_det[0], np.float32),
    )
    print(f"wrote {OUT_GAUSS} ({os.path.getsize(OUT_GAUSS)} bytes)")


if __name__ == "__main__":
    main()
