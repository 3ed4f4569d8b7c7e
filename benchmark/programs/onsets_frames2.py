"""The port's Onsets & Frames 2: ``features.MelSpec`` ->
``models.OnsetsFrames2`` behind ``serving.TranscriptionPipeline``, and
``train.make_train_step`` with ``torch.optim.Adam``."""

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


def _model(config, params, dtype, device):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    profile = tools.PianoProfile()
    if (profile.low, profile.get_range_len()) != (config['lowest_key'],
                                                  config['num_keys']):
        raise ValueError('the piano profile does not span the configuration'
                         "'s keys")
    model = OnsetsFrames2(dim_in=config['n_mels'], profile=profile,
                          model_complexity=config['model_complexity'],
                          dtype=DTYPES[dtype],
                          detach_heads=config['detach_heads'],
                          generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    model.load_state_dict(params, strict=True)

    return model


def features(config):
    from amt_tools_tpu_torch.features import MelSpec

    return MelSpec(sample_rate=config['sample_rate'],
                   hop_length=config['hop_length'], n_mels=config['n_mels'],
                   n_fft=config['n_fft'], htk=config['htk'])


def serving(config, params, device, capacity):
    from amt_tools_tpu_torch.serving import TranscriptionPipeline

    model = _model(config, params, config['serve_dtype'], device)

    return TranscriptionPipeline(model, features(config), capacity=capacity,
                                 device=device)


def language_models(model):
    """The model's BiLSTM layers, whose forwards the lstm spans cover."""

    return [module for name, module in model.named_children()
            if name.endswith('_lm')]


def training(config, params, device, optimizer):
    """(model, optimizer, step) for the configuration's training dtype."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.train import make_train_step

    tools.use_exact_fp32()
    model = _model(config, params, config['train_dtype'], device)
    opt = getattr(torch.optim, optimizer['name'])(model.parameters(),
                                                  lr=optimizer['lr'])

    return model, opt, make_train_step(model, opt)
