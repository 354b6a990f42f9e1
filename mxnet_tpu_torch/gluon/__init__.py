"""Gluon of the port: layers, recurrent layers and cells, losses and the
Trainer of the training slices."""
from . import loss, nn, rnn  # noqa: F401
from .trainer import Trainer  # noqa: F401

__all__ = ["loss", "nn", "rnn", "Trainer"]
