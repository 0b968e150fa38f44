"""Datasets, partitions and stacked federations (numpy, plus the torch
counter batch plan)."""
