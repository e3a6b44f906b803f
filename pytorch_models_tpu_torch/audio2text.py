"""Namespace alias mirroring the reference (`pytorch_models.audio2text`)."""

from .models.audio2text import *  # noqa: F401,F403
from .models.audio2text import __all__  # noqa: F401
