"""High-level API: ``Model.fit`` and its callbacks, ``summary`` and
``flops``."""

from . import callbacks  # noqa: F401
from .flops import flops  # noqa: F401
from .model import Model, summary  # noqa: F401

__all__ = ["Model", "summary", "callbacks", "flops"]
