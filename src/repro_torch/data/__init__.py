"""Synthetic datasets, out-of-core chunk sources and their fault-tolerant wrapper."""
