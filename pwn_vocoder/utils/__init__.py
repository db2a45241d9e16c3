from pwn_vocoder.utils import audio_io, dsp  # noqa: F401
