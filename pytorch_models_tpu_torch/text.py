"""Namespace alias mirroring the reference (`pytorch_models.text`)."""

from .models.text import *  # noqa: F401,F403
from .models.text import __all__  # noqa: F401
