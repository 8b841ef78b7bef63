"""Module layer: the generator's building blocks."""
from .layers import GRUCell, MLP, WarmupMLP, leaky_relu

__all__ = ["GRUCell", "MLP", "WarmupMLP", "leaky_relu"]
