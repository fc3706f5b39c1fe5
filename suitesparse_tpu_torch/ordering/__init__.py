"""Fill-reducing orderings of the port: AMD and nested dissection, both on
the pattern of A + A' and both in the host C++ library."""

from __future__ import annotations

from .amd import amd_order
from .nested_dissection import nested_dissection_order

__all__ = ["amd_order", "nested_dissection_order"]
