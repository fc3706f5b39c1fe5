"""Symbolic analysis of the port (etree, counts, supernodes)."""

from .etree import col_counts, ereach, etree, postorder
from .supernodes import SupernodalSymbolic, analyze_supernodal

__all__ = ["etree", "postorder", "col_counts", "ereach",
           "SupernodalSymbolic", "analyze_supernodal"]
