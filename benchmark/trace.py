"""The benchmark's spans, and what the traced run reads back from the
profiler.

Spans are ``torch.profiler.record_function`` ranges that the benchmark
opens around its calls into the port (``bench.dispatch``,
``bench.finalize``, ``bench.step``), around a module's forward through
hooks it registers (``bench.model``, ``bench.lm``, ``bench.forward``) and
around a method it wraps (``bench.features``). Without a profiler running
they cost a function call.

:class:`Trace` is the profiler's record of a traced stretch reduced to
plain data: the host events as a tree, each with the device kernels it
launched (attributed by the profiler's launch correlation, not by start
time), and the device events on their timeline.
"""

import contextlib
import functools
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function


def span(name):
    """A host range named ``name`` around a block."""

    return record_function(name)


def hook_module(module, name):
    """Open a range named ``name`` around every forward of ``module``.
    Returns the hook handles."""

    open_ranges = []

    def enter(module, args):
        rf = record_function(name)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(module, args, output):
        open_ranges.pop().__exit__(None, None, None)

    return [module.register_forward_pre_hook(enter),
            module.register_forward_hook(leave)]


def wrap_method(owner, attribute, name, after=None):
    """Replace ``owner.attribute`` (a bound method) by one that runs inside
    a range named ``name`` and hands its result to ``after``."""

    original = getattr(owner, attribute)

    @functools.wraps(original)
    def wrapped(*args, **kwargs):
        with record_function(name):
            result = original(*args, **kwargs)
        if after is not None:
            after(result)
        return result

    setattr(owner, attribute, wrapped)


@dataclass
class Node:
    name: str
    start: float
    end: float
    children: list = field(default_factory=list)


@dataclass
class Trace:
    """A traced stretch: ``roots`` the top-level host events (each a
    :class:`Node`), ``device`` every device operation (kernels, copies,
    sets) as ``(name, start_us, end_us, ranges)``, where ``ranges`` names
    the host events around its launch, innermost first; ``items`` the
    batches or steps it covers."""

    roots: list
    device: list
    items: int

    def nodes(self):
        stack = list(self.roots)
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children)

    def kernels_under(self, match, exclude=lambda name: False):
        """(name, us) of every device operation launched inside a host
        event whose name ``match`` accepts and not inside one that
        ``exclude`` accepts within it."""

        found = []
        for name, start, end, ranges in self.device:
            for outer in ranges:
                if exclude(outer):
                    break
                if match(outer):
                    found.append((name, end - start))
                    break

        return found

    def kernel_seconds(self, match, exclude=lambda name: False):
        kernels = self.kernels_under(match, exclude)
        if not kernels:
            return None
        return sum(us for _, us in kernels) * 1e-6

    def device_kernels(self, match):
        """(name, us) of every device operation whose name ``match``
        accepts."""

        return [(name, end - start) for name, start, end, _ in self.device
                if match(name)]

    def busy(self):
        """(busy seconds, window seconds, busy intervals): the union of the
        device operations' intervals, over the window from the first one's
        start to the last one's end."""

        if not self.device:
            return None
        intervals = sorted((start, end) for _, start, end, _ in self.device)
        merged = [list(intervals[0])]
        for start, end in intervals[1:]:
            if start > merged[-1][1]:
                merged.append([start, end])
            elif end > merged[-1][1]:
                merged[-1][1] = end
        busy = sum(end - start for start, end in merged)
        window = merged[-1][1] - merged[0][0]

        return busy * 1e-6, window * 1e-6, merged

    def device_ops(self, top=10):
        """The device operations that took the most time: [name, seconds]."""

        totals = {}
        for name, start, end, _ in self.device:
            totals[name] = totals.get(name, 0.0) + (end - start) * 1e-6

        return [[name[:200], seconds] for name, seconds in
                sorted(totals.items(), key=lambda item: -item[1])[:top]]

    def idle_gaps(self, top=10):
        """The device's idle time between operations, summed by what the
        host was doing when each gap opened (the innermost benchmark range
        and the innermost host event around it): [label, seconds]."""

        measured = self.busy()
        if measured is None:
            return []
        merged = measured[2]
        totals = {}
        for (_, end), (start, _) in zip(merged, merged[1:]):
            label = self.host_activity(end)
            totals[label] = totals.get(label, 0.0) + (start - end) * 1e-6

        return [[label[:200], seconds] for label, seconds in
                sorted(totals.items(), key=lambda item: -item[1])[:top]]

    def host_activity(self, at):
        """'<innermost bench range> > <innermost host event>' at ``at``
        (us), following the latest-started host event at each level."""

        bench, inner = None, None
        nodes = [node for node in self.roots if node.start <= at <= node.end]
        while nodes:
            node = max(nodes, key=lambda n: n.start)
            if node.name.startswith('bench.'):
                bench = node.name
            inner = node.name
            nodes = [child for child in node.children
                     if child.start <= at <= child.end]

        if inner is None:
            return 'host outside any range'

        return f'{bench or "no bench range"} > {inner}'


# Host calls that put work on the device: the device operation they
# launch carries the same correlation id
LAUNCHES = ('cuda', 'cu')


def reduce_profile(events, items):
    """The profiler's ``events()`` -> :class:`Trace`.

    Each device operation is given to the host events around the runtime
    or driver call that launched it (the call whose correlation id it
    carries), never by its start time. The device timeline's copies of the
    host's ranges (user annotations) are no device work and are left
    out."""

    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU and
            not getattr(e, 'is_async', False)]
    nodes = {id(e): Node(e.name, e.time_range.start, e.time_range.end)
             for e in host}
    roots = []
    for event in host:
        parent = event.cpu_parent
        if parent is not None and id(parent) in nodes:
            nodes[id(parent)].children.append(nodes[id(event)])
        else:
            roots.append(nodes[id(event)])

    annotations = {e.name for e in events
                   if getattr(e, 'is_user_annotation', False) or
                   e.name.startswith('bench.')}
    launches = {e.id: e for e in host if e.name.startswith(LAUNCHES)}
    device = []
    for event in events:
        if (event.device_type != DeviceType.CUDA or
                event.name in annotations):
            continue
        ranges = []
        launch = launches.get(event.id)
        while launch is not None:
            ranges.append(launch.name)
            launch = launch.cpu_parent
        device.append((event.name, event.time_range.start,
                       event.time_range.end, tuple(ranges)))

    return Trace(roots=roots, device=device, items=items)


class Profiler:
    """The traced stretch's profiler: host and device activity, no shapes,
    no stacks, nothing written to disk."""

    def __init__(self, device):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.activities = activities
        self.prof = None

    def warm(self):
        """Start and stop once, so that the first stretch does not pay the
        tracer's initialization."""

        with torch.profiler.profile(activities=self.activities):
            torch.zeros(1).add_(1)

    @contextlib.contextmanager
    def stretch(self):
        self.prof = torch.profiler.profile(activities=self.activities)
        self.prof.__enter__()
        try:
            yield
        finally:
            self.prof.__exit__(None, None, None)

    def reduce(self, items):
        return reduce_profile(self.prof.events(), items)
