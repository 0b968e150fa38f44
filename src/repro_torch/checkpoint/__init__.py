"""Checkpoints in the reference's file format (``io``)."""
