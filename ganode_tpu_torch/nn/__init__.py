"""Module layer: the generator's and discriminators' building blocks."""
from .layers import MLP, BatchNorm, GRUCell, Noise, WarmupMLP, leaky_relu
from .moe import MoEField, moe_field
from .spectral import SNConv, SNDense, spectral_normalize

__all__ = ["BatchNorm", "GRUCell", "MLP", "MoEField", "Noise", "SNConv",
           "SNDense", "WarmupMLP", "leaky_relu", "moe_field",
           "spectral_normalize"]
