from .convnext import ConvNeXt
from .detr import DETR, DETRPipeline
from .maxvit import MaxViT
from .mlp_mixer import MLPMixer
from .mobile_vit import MobileViT
from .vit import ViT

__all__ = ["ConvNeXt", "DETR", "DETRPipeline", "MaxViT", "MLPMixer", "MobileViT", "ViT"]
