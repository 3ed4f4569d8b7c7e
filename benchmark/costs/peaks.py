"""Published peaks of the cards the benchmark runs on.

A copy of ``amt_tools_tpu_torch/profiling.py``'s table: NVIDIA's data sheet
for the H100 SXM part, dense rates without sparsity, at its 700 W limit.
"""

# Card name fragment -> (FLOP/s by compute precision, HBM bytes/s)
PEAKS = {
    'H100 80GB HBM3': ({'bf16': 989e12, 'fp16': 989e12, 'tf32': 495e12,
                        'float32': 67e12, 'int8': 1979e12, 'fp8': 1979e12},
                       3.35e12),
}


def peaks(device_name):
    """(FLOP/s by precision, bytes/s) of the card named ``device_name``;
    None for a card the table does not know."""

    for key, value in PEAKS.items():
        if key in device_name:
            return value

    return None
