from .download import hub_download
from .params import StateDict, cast_tree, from_jax_params, quantize_tree_int8, to_tensor, tree_map

__all__ = ["hub_download", "StateDict", "cast_tree", "from_jax_params", "quantize_tree_int8", "to_tensor", "tree_map"]
