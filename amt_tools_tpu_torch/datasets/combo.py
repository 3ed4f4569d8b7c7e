"""Union of several transcription datasets.

Counterpart of ``amt_tools_tpu/datasets/combo.py``: one track list across
the datasets, each track routed to the dataset that owns it.
"""

__all__ = ['DatasetCombo']


class DatasetCombo(object):
    """Present several datasets as one (their track lists concatenated)."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError('DatasetCombo requires at least one dataset.')

        self.datasets = datasets

        # Global track list, each track with the index of its dataset
        self.tracks = []
        self._owner = []
        for d_idx, dataset in enumerate(datasets):
            for track in dataset.tracks:
                self.tracks.append(track)
                self._owner.append(d_idx)

    def __len__(self):
        return len(self.tracks)

    def _dataset_for(self, index):
        return self.datasets[self._owner[index]]

    def __getitem__(self, index):
        return self.get_item(index)

    def get_item(self, index, rng=None):
        """The owning dataset's ``get_item`` (with the loader's explicit
        crop RNG)."""

        dataset = self._dataset_for(index)
        local_index = dataset.tracks.index(self.tracks[index])

        return dataset.get_item(local_index, rng=rng)

    def get_track_frames(self, track_id):
        """The owning dataset's frame count of a track."""

        for dataset in self.datasets:
            if track_id in dataset.tracks:
                return dataset.get_track_frames(track_id)

        raise KeyError(f'Track {track_id!r} not found in any dataset.')

    def get_track_data(self, track_id, **kwargs):
        """The owning dataset's data of a track."""

        for dataset in self.datasets:
            if track_id in dataset.tracks:
                return dataset.get_track_data(track_id, **kwargs)

        raise KeyError(f'Track {track_id!r} not found in any dataset.')

    @classmethod
    def dataset_name(cls):
        return cls.__name__
