"""Datasets: the transcription dataset base class, the seeded native
loader and synthetic piano and guitar tracks."""

from .common import DataLoader, TranscriptionDataset, collate
from .synthetic import (SyntheticGuitar, SyntheticPiano, add_room,
                        random_notes, render_notes)

__all__ = ['TranscriptionDataset', 'DataLoader', 'collate', 'SyntheticPiano',
           'SyntheticGuitar', 'add_room', 'random_notes', 'render_notes']
