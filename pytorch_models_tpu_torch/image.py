"""Namespace alias mirroring the reference (`pytorch_models.image`)."""

from .models.image import *  # noqa: F401,F403
from .models.image import __all__  # noqa: F401
