"""The reduction of a profiler record: device work given to the host
ranges around its launch by correlation id, annotations left out, busy
and idle time, and the readers that use them."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, trace


def event(name, start, end, device=DeviceType.CPU, parent=None, eid=0,
          annotation=False):
    return SimpleNamespace(name=name, device_type=device, cpu_parent=parent,
                           id=eid, is_async=False, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def profile():
    """Two batches: each a bench.model range holding an op that launches
    one kernel and a bench.lm range holding an op that launches two; a
    bench.finalize range that waits 30 us of its 100."""

    events = []
    for b, t in enumerate((0, 1000)):
        model = event('bench.model', t, t + 500, annotation=True)
        conv = event('aten::conv2d', t + 10, t + 50, parent=model)
        launch = event('cudaLaunchKernel', t + 20, t + 30, parent=conv,
                       eid=10 * b + 1)
        lm = event('bench.lm', t + 100, t + 400, parent=model,
                   annotation=True)
        scan = event('amt::lstm_scan', t + 110, t + 300, parent=lm)
        launches = [event('cuLaunchKernelEx', t + 120 + k, t + 121 + k,
                          parent=scan, eid=10 * b + 2 + k) for k in range(2)]
        final = event('bench.finalize', t + 500, t + 600, annotation=True)
        wait = event('cudaEventSynchronize', t + 510, t + 540, parent=final)
        events += [model, conv, launch, lm, scan, *launches, final, wait]
        events += [event('conv_kernel', t + 40, t + 140, DeviceType.CUDA,
                         eid=10 * b + 1),
                   event('lstm_scan_kernel<bf16>', t + 140, t + 340,
                         DeviceType.CUDA, eid=10 * b + 2),
                   event('lstm_scan_kernel<bf16>', t + 340, t + 540,
                         DeviceType.CUDA, eid=10 * b + 3),
                   # The device timeline's copy of a host range
                   event('bench.model', t, t + 540, DeviceType.CUDA)]

    return trace.reduce_profile(events, items=2)


def test_device_work_goes_to_the_ranges_around_its_launch():
    traced = profile()
    assert len(traced.device) == 6  # annotations left out
    model = traced.kernel_seconds(lambda n: n == 'bench.model',
                                  exclude=lambda n: n == 'bench.lm')
    assert model == pytest.approx(2 * 100e-6)
    lm = traced.kernel_seconds(lambda n: n == 'bench.lm')
    assert lm == pytest.approx(2 * 400e-6)
    whole = traced.kernel_seconds(lambda n: n == 'bench.model')
    assert whole == pytest.approx(2 * 500e-6)
    assert traced.kernel_seconds(lambda n: n == 'bench.none') is None


def test_busy_window_and_idle_gaps():
    busy, window, _ = profile().busy()
    assert busy == pytest.approx(2 * 500e-6)
    assert window == pytest.approx((1540 - 40) * 1e-6)
    gaps = dict(profile().idle_gaps())
    assert sum(gaps.values()) == pytest.approx(window - busy)
    assert list(gaps) == ['bench.finalize > cudaEventSynchronize']


def test_the_readers_per_batch():
    readers_record = harness.Record.__new__(harness.Record)
    readers_record.trace = profile()
    readers_record.peaks = ({'bf16': 1e12, 'float32': 1e12}, 1e12)
    from benchmark import readers

    assert readers.kernel_ms(readers_record, lambda n: n == 'bench.lm') == (
        pytest.approx(0.4))
    assert readers.lstm_seconds(readers_record, under='bench.lm') == (
        pytest.approx(400e-6))
    assert readers.idle(readers_record) == pytest.approx(
        100 * (1 - 1000 / 1500))
    decode = harness.load_code('metrics', 'decode.host_ms')
    assert decode.read(readers_record) == pytest.approx(0.07)
    # 100 x least (2 us by operations) over the 400 us taken
    assert readers.roofline(readers_record, [(2e6, 1.0)], 'bf16',
                            400e-6) == pytest.approx(0.5)


def test_nothing_to_read_is_none():
    record = harness.Record.__new__(harness.Record)
    record.trace = None
    record.peaks = None
    from benchmark import readers

    assert readers.idle(record) is None
    assert readers.kernel_ms(record, lambda n: True) is None
    assert readers.roofline(record, [(1.0, 1.0)], 'bf16', 1.0) is None
