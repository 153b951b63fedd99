"""``paddle.utils``: the commit protocol the serving resilience and the
incident bundles write through (:mod:`.durability`). The reference's
other utilities (``custom_device``, ``custom_op``, ``dlpack``) are ROADMAP
A9."""

from . import durability  # noqa: F401

__all__ = ["durability"]
