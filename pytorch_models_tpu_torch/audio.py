"""Namespace alias mirroring the reference (`pytorch_models.audio`)."""

from .models.audio import *  # noqa: F401,F403
from .models.audio import __all__  # noqa: F401
