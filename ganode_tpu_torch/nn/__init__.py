"""Module layer: the generator's and discriminators' building blocks."""
from .layers import MLP, BatchNorm, GRUCell, Noise, WarmupMLP, leaky_relu

__all__ = ["BatchNorm", "GRUCell", "MLP", "Noise", "WarmupMLP", "leaky_relu"]
