"""Compute ops: bit packing, thresholds, conv helpers, golden references."""
