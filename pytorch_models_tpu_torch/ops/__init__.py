from .attention import sdpa
from .layers import ACT_FNS, conv1d, conv2d, layer_norm, linear, linear_init, ln_init

__all__ = ["sdpa", "ACT_FNS", "conv1d", "conv2d", "layer_norm", "linear", "linear_init", "ln_init"]
