"""Attention core: masks, the dispatch seam and cache decode."""
