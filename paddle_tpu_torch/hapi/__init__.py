"""High-level API: ``Model.fit`` and its callbacks."""

from . import callbacks  # noqa: F401
from .model import Model, summary  # noqa: F401

__all__ = ["Model", "summary", "callbacks"]
