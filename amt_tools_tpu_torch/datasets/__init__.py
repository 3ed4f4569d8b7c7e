"""Datasets: the transcription dataset base class, MAPS, MAESTRO V1-V3,
GuitarSet, their union, synthetic piano and guitar tracks, and the seeded
native loader."""

from .combo import DatasetCombo
from .common import DataLoader, TranscriptionDataset, collate
from .guitarset import GuitarSet
from .maestro import MAESTRO_V1, MAESTRO_V2, MAESTRO_V3
from .maps import MAPS
from .synthetic import (SyntheticGuitar, SyntheticPiano, add_room,
                        random_notes, render_notes)

__all__ = ['TranscriptionDataset', 'DataLoader', 'collate', 'MAPS',
           'MAESTRO_V1', 'MAESTRO_V2', 'MAESTRO_V3', 'GuitarSet',
           'DatasetCombo', 'SyntheticPiano', 'SyntheticGuitar', 'add_room',
           'random_notes', 'render_notes']
