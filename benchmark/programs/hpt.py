"""The port's High-resolution Piano Transcription note model:
``features.MelSpec`` (reflect-padded, 30 Hz to 8 kHz, absolute dB) ->
``models.RegressCRNN`` behind ``serving.RegressionPipeline``."""

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


def _model(config, params, dtype, device):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import RegressCRNN

    profile = tools.PianoProfile()
    if (profile.low, profile.get_range_len()) != (config['lowest_key'],
                                                  config['num_keys']):
        raise ValueError('the piano profile does not span the configuration'
                         "'s keys")
    model = RegressCRNN(dim_in=config['n_mels'], profile=profile,
                        dtype=DTYPES[dtype],
                        generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    model.load_state_dict(params, strict=True)

    return model


def features(config):
    from amt_tools_tpu_torch.features import MelSpec

    return MelSpec(sample_rate=config['sample_rate'],
                   hop_length=config['hop_length'], n_mels=config['n_mels'],
                   n_fft=config['n_fft'], fmin=config['fmin'],
                   fmax=config['fmax'], absolute_db=True, pad_mode='reflect')


def serving(config, params, device, capacity):
    from amt_tools_tpu_torch.serving import RegressionPipeline

    model = _model(config, params, config['serve_dtype'], device)

    return RegressionPipeline(model, features(config), capacity=capacity,
                              device=device)


def language_models(model):
    """No module of the model is a language model the ``bench.lm`` hooks
    could time: its GRUs run grouped across modules (``amt.gru``)."""

    return []
