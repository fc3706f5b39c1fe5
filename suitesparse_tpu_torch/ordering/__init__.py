"""Fill-reducing orderings of the port: AMD and nested dissection on the
pattern of A + A', COLAMD on the pattern of A'A (for QR), and the block
triangular form of the LU path (:mod:`.btf`), all in the host C++
library."""

from __future__ import annotations

from .amd import amd_order
from .colamd import colamd_order
from .nested_dissection import nested_dissection_order

__all__ = ["amd_order", "colamd_order", "nested_dissection_order"]
