"""Batched rendering of many graph instances."""

from .mesh import BatchRenderer

__all__ = ["BatchRenderer"]
