"""The port's MT3 piano transcriber: ``features.MelSpec`` (MT3's: |STFT|,
TensorFlow's mel bank from 20 Hz to 7.6 kHz, frames padded at the end,
``log(max(mel, 1e-5))``) -> ``models.Seq2SeqTranscriber`` (greedy decode
through its cache) behind ``serving.Seq2SeqPipeline``, ``capacity``
tokens a segment."""

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}

WIDTHS = ('n_mels', 'emb_dim', 'num_heads', 'head_dim', 'mlp_dim',
          'num_encoder_layers', 'num_decoder_layers', 'vocab_size')


def _model(config, params, dtype, device):
    from amt_tools_tpu_torch.models import Seq2SeqTranscriber

    model = Seq2SeqTranscriber(max_len=config['outputs_length'],
                               dtype=DTYPES[dtype],
                               generator=torch.Generator().manual_seed(0),
                               **{key: config[key] for key in WIDTHS})
    model = model.to(device)
    model.load_state_dict(params, strict=True)

    return model


def features(config):
    from amt_tools_tpu_torch.features import MelSpec

    return MelSpec(sample_rate=config['sample_rate'],
                   hop_length=config['hop_length'], n_mels=config['n_mels'],
                   n_fft=config['n_fft'], center=False, pad_end=True,
                   magnitude=True, filterbank='tf', fmin=config['fmin'],
                   fmax=config['fmax'], log_floor=config['log_floor'])


def serving(config, params, device, capacity):
    from amt_tools_tpu_torch.serving import Seq2SeqPipeline

    model = _model(config, params, config['serve_dtype'], device)

    return Seq2SeqPipeline(model, features(config), capacity=capacity,
                           input_length=config['input_length'], device=device)


def language_models(model):
    """No module of the model is a language model the ``bench.lm`` hooks
    could time."""

    return []
