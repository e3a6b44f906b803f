from .params import StateDict, cast_tree, from_jax_params, to_tensor, tree_map

__all__ = ["StateDict", "cast_tree", "from_jax_params", "to_tensor", "tree_map"]
