"""Synthetic audio for benchmarks and smoke tests."""

from .synthetic import random_notes, render_notes

__all__ = ['random_notes', 'render_notes']
