"""Arithmetic of the metrics that read the port's own spans.

The port opens ``record_function`` ranges named ``amt.<layer>`` at its
layer boundaries while a profiler records (``amt_tools_tpu_torch.
profiling.span``), on whichever host thread runs the layer: the LSTMs'
backward runs on autograd's device thread. A reader returns None where the
traced stretch holds no such span (no trace, or a port without spans):
the metric is then left out of the line.
"""

from . import readers

PREFIX = 'amt.'


def device_ms(record, *names):
    """Device ms a batch or step of the operations launched inside a span
    named in ``names`` (by the launch's correlation, never by start
    time)."""

    return readers.kernel_ms(record, lambda name: name in names)


def host_ms(record, name):
    """Host ms a batch or step inside the spans named ``name``."""

    if record.trace is None or not record.trace.items:
        return None
    spans = [node for node in record.trace.nodes() if node.name == name]
    if not spans:
        return None

    return sum(n.end - n.start for n in spans) * 1e-3 / record.trace.items


def _owned(roots, names):
    """(start, end, owned) of every ``amt.`` span under ``roots``: owned
    when the span is named in ``names`` or lies inside one that is."""

    found = []
    stack = [(node, False) for node in roots]
    while stack:
        node, inside = stack.pop()
        if node.name.startswith(PREFIX):
            inside = inside or node.name in names
            found.append((node.start, node.end, inside))
        stack.extend((child, inside) for child in node.children)

    return found


def idle_ms(record, *names):
    """Device idle ms a batch or step in the gaps put down to the spans
    named in ``names``.

    A gap runs from the end of one busy interval of the device to the
    start of the next (``Trace.busy``). It is put down to the ``amt.``
    span that started latest among those open at the gap's start, on any
    host thread, and counts here when that span is named in ``names`` or
    lies inside one that is."""

    if record.trace is None or not record.trace.items:
        return None
    spans = _owned(record.trace.roots, set(names))
    measured = record.trace.busy()
    if measured is None or not any(owned for _, _, owned in spans):
        return None
    merged = measured[2]
    total = 0.0
    for (_, end), (start, _) in zip(merged, merged[1:]):
        open_spans = [span for span in spans if span[0] <= end <= span[1]]
        if open_spans and max(open_spans,
                              key=lambda s: (s[0], -s[1]))[2]:
            total += start - end

    return total * 1e-3 / record.trace.items
