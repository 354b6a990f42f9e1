"""Gluon of the port: layers, losses and the Trainer of the training
slice."""
from . import loss, nn  # noqa: F401
from .trainer import Trainer  # noqa: F401

__all__ = ["loss", "nn", "Trainer"]
