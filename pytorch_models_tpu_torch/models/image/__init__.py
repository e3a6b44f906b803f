from .vit import ViT

__all__ = ["ViT"]
