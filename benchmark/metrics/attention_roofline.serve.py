"""The serving attention's share of its roofline: the least time of a
forward's attention calls (``costs/<family>.py`` ``attention_cost``: the
score and value products at the card's peak in the served dtype, or Q, K,
V and O read or written once at its bandwidth, whichever is longer, a
call) over the device time of the fused attention kernels launched inside
the port's ``amt.transformer`` spans, a batch.

The kernels are PyTorch's ``scaled_dot_product_attention`` backends, by
the names the trace gives them: the flash kernel (``flash_fwd``), the
memory-efficient one (``fmha_cutlass``) and cuDNN's (``sdpa``)."""

from benchmark import readers

KERNELS = ('flash_fwd', 'fmha_cutlass', 'sdpa')


def read(record):
    if record.trace is None or not hasattr(record.costs, 'attention_cost'):
        return None
    kernels = [us for name, us in record.trace.kernels_under(
        lambda name: name == 'amt.transformer')
        if any(kernel in name for kernel in KERNELS)]
    if not kernels:
        return None
    config = record.config
    size = 2 if config['serve_dtype'] == 'bfloat16' else 4
    costs = record.costs.attention_cost(config, record.shape['batch'],
                                        record.shape['frames'], size)

    return readers.roofline(record, costs,
                            readers.PRECISION[config['serve_dtype']],
                            readers.per_item(record, sum(kernels) * 1e-6))
