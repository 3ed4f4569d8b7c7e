"""TabCNN guitar tablature model.

Counterpart of ``amt_tools_tpu/models/tabcnn.py`` ``TabCNN`` (``:23``), in
eval mode and in train mode (``:134-183``: dropouts of 0.25 after the pool
and 0.5 after ``dense1``, drawn from the forward's explicit generator and
gated by ``dropout``; the CE loss in ``post_proc``). Submodule names follow
the Flax tree (``conv1``, ``conv2``,
``conv3``, ``dense1``, ``tablature_out.Dense_0``), so ``weights.from_flax``
maps one onto the other by name.

The feature image stays (B, C, F, T): frequency is the height and time (or
the window) the width, so a Flax (3, 3, Cin, Cout) kernel with H = F and
W = T becomes the OIHW weight by the usual transpose. Before the flatten
into ``dense1`` the port permutes to (B, T, F', C) (or (N, F', W', C) for
windows), so the flatten is frequency-major exactly as in the JAX package
(``tabcnn.py:158-160``) and the dense rows need no permutation.

With ``quant_acoustic`` (serving only) ``conv1``-``conv3`` and ``dense1``
are int8 layers (``ops.qconv``, JAX ``:104-117``). In the dynamic mode a
conv's per-sample scale covers what its batch axis holds: a whole clip in
``fullseq``, one context window in the windowed forward, as in JAX.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import profiling, tools
from ..ops import frames as frame_ops
from ..ops.layers import conv2d_valid, conv3x3, dropout, lecun_normal_, linear
from ..ops.qconv import Int8Conv, Int8Dense
from .common import SoftmaxGroups, TranscriptionModel

__all__ = ['TabCNN']


class TabCNN(TranscriptionModel):
    """Per-frame context-window CNN with a softmax-group tablature output.

    Three 3x3 VALID convs (32, 64, 64 channels at complexity 1) with ReLU, a
    2x2 max-pool, a 128-wide dense with ReLU and a ``SoftmaxGroups`` head.
    ``fullseq=True`` runs the conv stack once over the whole zero-padded
    (F, T + 8) image instead of over T 9-frame windows: every conv is VALID,
    so output position t is what window t computes, and the per-window
    (2, 2)/(2, 2) pool over the 3 surviving window positions becomes a
    (2, 2)/(2, 1) pool over time (the JAX class docstring). Both modes share
    the parameters. Dropout is the identity at inference; in train mode with
    ``dropout`` on it draws from the forward's ``generator``.
    """

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=1,
                 frame_width=9, online=False, fullseq=False, dtype=None,
                 generator=None, dropout=True, quant_acoustic=False,
                 quant_lm=False):
        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity,
                         frame_width=frame_width, dtype=dtype,
                         dropout=dropout, quant_acoustic=quant_acoustic,
                         quant_lm=quant_lm)
        self.online = online
        self.fullseq = fullseq
        # Three 3x3 VALID convs leave frame_width - 6 window positions; the
        # (2, 1)-strided pool and trim reproduce the per-window pool only
        # when that count is 3 (frame_width == 9, the reference geometry)
        if fullseq and frame_width != 9:
            raise ValueError(
                f'fullseq=True requires frame_width == 9 (the geometry whose '
                f'pool equivalence is established); got {frame_width}. '
                f'Use the windowed forward (fullseq=False) for other widths.')

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        nf1 = 32 * model_complexity
        nf2 = 64 * model_complexity
        embedding = 128 * model_complexity

        static = quant_acoustic == 'static'

        def conv(in_channels, out_channels):
            if quant_acoustic:
                return Int8Conv(in_channels, out_channels, padding='VALID',
                                dtype=dtype, static_scale=static,
                                generator=generator)
            return conv3x3(in_channels, out_channels, generator)

        self.conv1 = conv(in_channels, nf1)
        self.conv2 = conv(nf1, nf2)
        self.conv3 = conv(nf2, nf2)

        # Three VALID 3x3 convs take 6 from each spatial axis, the pool halves
        features = nf2 * ((dim_in - 6) // 2) * ((frame_width - 6) // 2)
        if quant_acoustic:
            self.dense1 = Int8Dense(features, embedding, dtype=dtype,
                                    static_scale=static, generator=generator)
        else:
            self.dense1 = nn.Linear(features, embedding)
            lecun_normal_(self.dense1.weight, features, generator)
            nn.init.zeros_(self.dense1.bias)

        self.tablature_out = SoftmaxGroups(
            embedding, self.num_groups * self.num_classes,
            num_groups=self.num_groups, num_classes=self.num_classes,
            dtype=dtype, generator=generator)

    @property
    def num_groups(self):
        return self.profile.get_num_dofs()

    @property
    def num_classes(self):
        return self.profile.num_pitches + 1

    def pre_proc(self, batch):
        """Lay out (B, C, F, T) features for the forward.

        fullseq: one zero-padded (B, C, F, T + W - 1) image (the padding
        ``framify`` applies, so edge frames match the windows). Windowed:
        (B, T', C, F, W) context windows; in online mode the features already
        span one window and are not padded.
        """

        batch = dict(batch)
        feats = batch[tools.KEY_FEATS]

        if self.fullseq:
            pad = self.frame_width // 2
            batch[tools.KEY_FEATS] = F.pad(feats, (pad, pad))
            return batch

        # (B, C, F, T) -> (B, C, F, T', W) -> (B, T', C, F, W)
        feats = frame_ops.framify(feats, self.frame_width,
                                  pad=(not self.online))
        batch[tools.KEY_FEATS] = feats.permute(0, 3, 1, 2, 4)

        return batch

    def _convs(self, x):
        x = F.relu(conv2d_valid(x, self.conv1, self.dtype))
        x = F.relu(conv2d_valid(x, self.conv2, self.dtype))
        return F.relu(conv2d_valid(x, self.conv3, self.dtype))

    def _dropout(self, x, rate, generator):
        if self.training and self.dropout:
            return dropout(x, rate, generator)
        return x

    def forward(self, feats, generator=None):
        """:meth:`pre_proc` features -> {tablature: (B, T, G*C) logits}; in
        train mode dropout draws from ``generator``."""

        if self.fullseq:
            batch_size = feats.shape[0]
            num_frames = feats.shape[-1] - (self.frame_width - 1)

            with profiling.span('amt.acoustic'):
                x = self._convs(feats)
                # Per-window pool over its 3 surviving positions keeps
                # max(pos 0, pos 1) -> full-sequence positions (t, t + 1)
                x = F.max_pool2d(x, (2, 2), stride=(2, 1))
            x = self._dropout(x[..., :num_frames], 0.25, generator)

            # (B, C, F', T) -> (B, T, F', C): the windowed flatten order
            x = x.permute(0, 3, 2, 1)
        else:
            batch_size, num_frames = feats.shape[:2]

            # Each context window is an independent sample of the stack
            with profiling.span('amt.acoustic'):
                x = self._convs(feats.reshape((-1,) + feats.shape[2:]))
                x = F.max_pool2d(x, (2, 2), stride=(2, 2))
            x = self._dropout(x, 0.25, generator)

            # (N, C, F', W') -> (N, F', W', C)
            x = x.permute(0, 2, 3, 1)

        x = x.reshape(batch_size, num_frames, -1)
        x = F.relu(linear(x, self.dense1, self.dtype))
        x = self._dropout(x, 0.5, generator)

        return {tools.KEY_TABLATURE: self.tablature_out(x)}

    def post_proc(self, batch):
        """The tablature CE loss, where the batch has tablature (JAX
        ``:185-203``), and the argmax tablature (B, G, T), -1 for silence."""

        output = dict(batch[tools.KEY_OUTPUT])
        tablature_est = output[tools.KEY_TABLATURE]

        if tools.KEY_TABLATURE in batch:
            loss = self.tablature_out.get_loss(tablature_est,
                                               batch[tools.KEY_TABLATURE])
            output[tools.KEY_LOSS] = {tools.KEY_LOSS_TOTAL: loss}

        output[tools.KEY_TABLATURE] = self.tablature_out.finalize_output(
            tablature_est)

        return output
