"""Module layer: the generator's and discriminators' building blocks."""
from .gresblock import Conv2dODEField, GResBlock, ODEGResBlock
from .layers import MLP, BatchNorm, GRUCell, Noise, WarmupMLP, leaky_relu
from .moe import MoEField, moe_field
from .norm import ConditionalNorm
from .spectral import SNConv, SNDense, spectral_normalize

__all__ = ["BatchNorm", "ConditionalNorm", "Conv2dODEField", "GRUCell",
           "GResBlock", "MLP", "MoEField", "Noise", "ODEGResBlock", "SNConv",
           "SNDense", "WarmupMLP", "leaky_relu", "moe_field",
           "spectral_normalize"]
