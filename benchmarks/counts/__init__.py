"""Bytes and operations worked out from shapes."""
