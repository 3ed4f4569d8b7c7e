"""The readers of the port's own spans (``program_spans.py`` and the nine
metrics that use it), on hand-built traces: device time by the spans
around each launch, host time inside a span, and idle gaps put down to the
latest-started ``amt.`` span open on any thread."""

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Node, Trace

SERVE = ('features.device_ms.serve', 'acoustic.device_ms.serve',
         'lstm.device_ms.serve', 'decode.device_ms.serve',
         'decode.host_ms.serve', 'decode.idle_ms.serve')
TRAIN = ('train.forward_ms', 'lstm.device_ms.train', 'lstm.idle_ms.train')


def record(trace):
    made = harness.Record.__new__(harness.Record)
    made.trace = trace
    made.peaks = None

    return made


def read(name, trace):
    return harness.load_code('metrics', name).read(record(trace))


def serving():
    """Two batches 1000 us apart. Each: ``bench.dispatch`` holding
    ``amt.features`` (one 20 us kernel), ``amt.acoustic`` (a 100 us kernel,
    launched inside the span but run after it closed), ``amt.lstm`` (two 30
    us kernels) and ``amt.decode`` (a 10 us kernel); then
    ``bench.finalize``, whose ``amt.serving.decode_host`` holds a
    re-decode's ``amt.features`` (one 5 us kernel)."""

    roots, device = [], []
    for t in (0, 1000):
        dispatch = Node('bench.dispatch', t, t + 200, [
            Node('amt.features', t, t + 20, [Node('cudaLaunchKernel', t + 1,
                                                   t + 2)]),
            Node('amt.acoustic', t + 20, t + 60, [Node('cudaLaunchKernel',
                                                      t + 21, t + 22)]),
            Node('amt.lstm', t + 60, t + 100),
            Node('amt.decode', t + 100, t + 110)])
        decode_host = Node('amt.serving.decode_host', t + 400, t + 700, [
            Node('amt.features', t + 500, t + 600)])
        roots += [dispatch, Node('bench.finalize', t + 300, t + 700, [
            Node('cudaEventSynchronize', t + 300, t + 390), decode_host])]
        features = ('cudaLaunchKernel', 'amt.features', 'bench.dispatch')
        device += [
            ('stft', t + 5, t + 25, features),
            ('conv', t + 100, t + 200, ('cudaLaunchKernel', 'amt.acoustic',
                                        'bench.dispatch')),
            ('lstm_scan', t + 200, t + 230, ('cuLaunchKernelEx', 'amt.lstm',
                                             'bench.dispatch')),
            ('lstm_scan', t + 230, t + 260, ('cuLaunchKernelEx', 'amt.lstm',
                                             'bench.dispatch')),
            ('notes', t + 260, t + 270, ('cudaLaunchKernel', 'amt.decode',
                                         'bench.dispatch')),
            ('stft', t + 560, t + 565, ('cudaLaunchKernel', 'amt.features',
                                        'amt.serving.decode_host',
                                        'bench.finalize'))]

    return Trace(roots=roots, device=device, items=2)


def test_device_time_goes_to_the_spans_around_each_launch():
    traced = serving()
    # The conv kernel ran after amt.acoustic closed: its launch decides
    assert read('acoustic.device_ms.serve', traced) == pytest.approx(0.1)
    assert read('features.device_ms.serve', traced) == pytest.approx(0.025)
    assert read('lstm.device_ms.serve', traced) == pytest.approx(0.06)
    assert read('decode.device_ms.serve', traced) == pytest.approx(0.01)


def test_host_time_inside_the_decode_span():
    # 300 us a batch, its wait for the device (outside the span) left out
    assert read('decode.host_ms.serve', serving()) == pytest.approx(0.3)


def test_idle_gaps_inside_the_host_decode():
    # Busy: [5, 25], [100, 270], [560, 565] and the same 1000 us on. The
    # gaps opening at 25 and 1025 fall in amt.acoustic, those at 270 and
    # 1270 in no amt. span; the one at 565, which lasts to 1005, in the
    # re-decode's amt.features, which lies inside decode_host
    assert read('decode.idle_ms.serve', serving()) == pytest.approx(
        (1005 - 565) * 1e-3 / 2)


def training(backward_start):
    """One step: the forward's ``amt.train.forward`` [0, 400] on the main
    thread with ``amt.acoustic`` [100, 300] inside it, and autograd's
    thread holding ``amt.lstm.backward`` from ``backward_start`` to 600,
    with one F kernel. The device is busy [0, 200], [250, 500] and
    [700, 800]: gaps open at 200 and at 500."""

    forward = Node('amt.train.forward', 0, 400, [
        Node('amt.acoustic', 100, 300), Node('amt.lstm', 300, 350)])
    autograd = Node('autograd::engine::evaluate_function: X', backward_start,
                    650, [Node('amt.lstm.backward', backward_start, 600)])
    device = [
        ('conv', 0, 200, ('cudaLaunchKernel', 'amt.acoustic',
                          'amt.train.forward')),
        ('lstm_scan_residuals', 250, 300, ('cuLaunchKernelEx', 'amt.lstm',
                                           'amt.train.forward')),
        ('lstm_bptt', 300, 500, ('cuLaunchKernelEx', 'amt.lstm.backward',
                                 'autograd::engine::evaluate_function: X')),
        ('adam', 700, 800, ('cudaLaunchKernel', 'Optimizer.step#Adam'))]

    return Trace(roots=[forward, autograd], device=device, items=1)


def test_a_gap_goes_to_the_latest_started_span_on_any_thread():
    # The backward's span (started at 50) is open on its thread when the
    # gap at 200 opens, but amt.acoustic started later (100): the gap is
    # the acoustic stack's; the gap at 500 opens in the backward's span
    # alone
    assert read('lstm.idle_ms.train', training(50)) == pytest.approx(0.2)
    # Started at 150, the backward's span is the latest at 200 too
    assert read('lstm.idle_ms.train', training(150)) == pytest.approx(
        0.05 + 0.2)


def test_the_training_readers():
    traced = training(50)
    assert read('train.forward_ms', traced) == pytest.approx(0.25)
    assert read('lstm.device_ms.train', traced) == pytest.approx(0.25)


@pytest.mark.parametrize('name', SERVE + TRAIN)
def test_nothing_to_read_is_none(name):
    assert read(name, None) is None
    # A trace of the port without spans: only the benchmark's ranges
    bare = Trace(roots=[Node('bench.dispatch', 0, 100),
                        Node('bench.finalize', 100, 200)],
                 device=[('conv', 0, 50, ('cudaLaunchKernel',
                                          'bench.dispatch')),
                         ('conv', 80, 90, ('cudaLaunchKernel',
                                           'bench.dispatch'))],
                 items=1)
    assert read(name, bare) is None


def test_each_serving_reader_finds_nothing_in_a_training_trace():
    traced = training(50)
    for name in ('features.device_ms.serve', 'decode.device_ms.serve',
                 'decode.host_ms.serve', 'decode.idle_ms.serve'):
        assert read(name, traced) is None
    assert program_spans.idle_ms(record(serving()), 'amt.lstm.backward') is (
        None)
