"""Host ms a batch inside the port's ``amt.serving.decode_host`` span:
``finalize``'s host note decode after its wait for the device,
re-decodes after a capacity overflow included."""

from benchmark import program_spans


def read(record):
    return program_spans.host_ms(record, 'amt.serving.decode_host')
