"""The port's hFT-Transformer: ``features.MelSpec`` (HTK scale with
Slaney's norm, 0 Hz to 8 kHz, ``log(mel + 1e-8)``) ->
``models.HFTransformer`` (margin-padded segments inside its forward)
behind ``serving.RegressionPipeline``, at the configuration's
thresholds."""

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}

WIDTHS = ('n_bin', 'n_margin', 'n_frame', 'cnn_channel', 'cnn_kernel',
          'hid_dim', 'n_layers', 'n_heads', 'pf_dim', 'n_velocity',
          'pad_value')


def _model(config, params, dtype, device):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import HFTransformer

    profile = tools.PianoProfile()
    if (profile.low, profile.get_range_len()) != (config['lowest_key'],
                                                  config['num_keys']):
        raise ValueError('the piano profile does not span the configuration'
                         "'s keys")
    model = HFTransformer(profile=profile, dtype=DTYPES[dtype],
                          generator=torch.Generator().manual_seed(0),
                          **{key: config[key] for key in WIDTHS})
    model = model.to(device)
    model.load_state_dict(params, strict=True)

    return model


def features(config):
    from amt_tools_tpu_torch.features import MelSpec

    return MelSpec(sample_rate=config['sample_rate'],
                   hop_length=config['hop_length'], n_mels=config['n_bin'],
                   n_fft=config['n_fft'], htk=True, fmin=config['fmin'],
                   fmax=config['fmax'], log_offset=config['log_offset'])


def serving(config, params, device, capacity):
    from amt_tools_tpu_torch.serving import RegressionPipeline

    model = _model(config, params, config['serve_dtype'], device)

    return RegressionPipeline(
        model, features(config), capacity=capacity, device=device,
        onset_threshold=config['onset_threshold'],
        offset_threshold=config['offset_threshold'],
        frame_threshold=config['frame_threshold'])


def language_models(model):
    """No module of the model is a language model the ``bench.lm`` hooks
    could time."""

    return []
