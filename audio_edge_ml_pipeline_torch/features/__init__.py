"""Feature extraction layer: containers, registry, extractors, pipeline.

Importing the concrete modules registers their extractors, as in the JAX
package's ``features/__init__.py``.
"""

from .base import BaseDatasetLoader, BaseFeatureExtractor, BatchedAudioExtractor, FeatureSet  # noqa: F401
from .registry import get, list_extractors, register  # noqa: F401

from . import audio as _audio  # noqa: E402,F401
from . import image as _image  # noqa: E402,F401
from . import tabular as _tabular  # noqa: E402,F401
from . import text as _text  # noqa: E402,F401
from . import video as _video  # noqa: E402,F401
