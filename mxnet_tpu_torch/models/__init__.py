"""Models of the port."""
from . import bert, decoder  # noqa: F401
