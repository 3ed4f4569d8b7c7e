"""The port's TabCNN: ``features.CQT`` -> ``models.TabCNN`` (whole-sequence
forward) behind ``serving.TablaturePipeline``, and the windowed model in
``train.make_train_step`` with ``torch.optim.Adadelta``."""

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


def _profile(config):
    from amt_tools_tpu_torch import tools

    profile = tools.GuitarProfile(num_frets=config['num_frets'])
    if list(profile.get_midi_tuning()) != list(config['tuning']):
        raise ValueError("the guitar profile's tuning is not the "
                         "configuration's")

    return profile


def _model(config, params, dtype, device, fullseq):
    from amt_tools_tpu_torch.models import TabCNN

    model = TabCNN(dim_in=config['n_bins'], profile=_profile(config),
                   model_complexity=config['model_complexity'],
                   frame_width=config['frame_width'], fullseq=fullseq,
                   dtype=DTYPES[dtype],
                   generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    model.load_state_dict(params, strict=True)

    return model


def features(config):
    from amt_tools_tpu_torch.features import CQT

    return CQT(sample_rate=config['sample_rate'],
               hop_length=config['hop_length'], n_bins=config['n_bins'],
               bins_per_octave=config['bins_per_octave'],
               fmin=440.0 * 2.0 ** ((config['fmin_midi'] - 69) / 12.0),
               exact=config['cqt_exact'], grouped=config['cqt_grouped'])


def serving(config, params, device, capacity):
    from amt_tools_tpu_torch.serving import TablaturePipeline

    model = _model(config, params, config['serve_dtype'], device,
                   fullseq=True)

    return TablaturePipeline(model, features(config), capacity=capacity,
                             device=device)


def language_models(model):
    return []


def training(config, params, device, optimizer):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.train import make_train_step

    tools.use_exact_fp32()
    model = _model(config, params, config['train_dtype'], device,
                   fullseq=False)
    opt = getattr(torch.optim, optimizer['name'])(model.parameters(),
                                                  lr=optimizer['lr'])

    return model, opt, make_train_step(model, opt)
