from pwn_vocoder.data.pipeline import (  # noqa: F401
    SyntheticSpeech,
    SyntheticTones,
    WavCropDataset,
    make_train_iterator,
    prefetch,
)
