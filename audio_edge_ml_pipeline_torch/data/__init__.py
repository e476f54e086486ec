"""Dataset loaders and raw-media I/O (host side of the data plane)."""

from .audio_io import load_audio, probe_audio, read_wav, write_wav  # noqa: F401
from .loaders import (  # noqa: F401
    AudioFolderLoader,
    BIRDeepImageLoader,
    BIRDeepLoader,
    FSC22Loader,
    ImageFolderLoader,
    TabularLoader,
    TextCSVLoader,
    TextFolderLoader,
    TextJSONLoader,
    VideoFolderLoader,
    build_loader,
)
