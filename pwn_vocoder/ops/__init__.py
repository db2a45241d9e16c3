from pwn_vocoder.ops import conv, mol  # noqa: F401
