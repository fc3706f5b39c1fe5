"""Symbolic analysis of the port (etree, counts, supernodes)."""

from .etree import (col_counts, ereach, etree, first_descendants, postorder,
                    tree_depth, tree_levels)
from .supernodes import SupernodalSymbolic, analyze_supernodal

__all__ = ["etree", "postorder", "col_counts", "ereach", "tree_levels",
           "tree_depth", "first_descendants", "SupernodalSymbolic",
           "analyze_supernodal"]
