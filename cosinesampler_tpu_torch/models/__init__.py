"""PINN model and trainer."""

from . import pinn, train

__all__ = ["pinn", "train"]
