"""Module layer: the generator's and discriminators' building blocks."""
from .layers import MLP, BatchNorm, GRUCell, Noise, WarmupMLP, leaky_relu
from .spectral import SNConv, SNDense, spectral_normalize

__all__ = ["BatchNorm", "GRUCell", "MLP", "Noise", "SNConv", "SNDense",
           "WarmupMLP", "leaky_relu", "spectral_normalize"]
