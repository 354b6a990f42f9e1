"""Models of the port."""
from . import decoder  # noqa: F401
