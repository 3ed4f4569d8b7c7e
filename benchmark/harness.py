"""One run of one cell: load its files by name, set up, measure, check,
and assemble the result line.

:func:`run` is what ``run.py`` calls once it has found the card; tests
call it on the CPU at small sizes (``device='cpu'``), where the line
carries no metric, since a CPU run measures no device.
"""

import importlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import torch

from .costs import peaks

HERE = Path(__file__).resolve().parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')

# Top-level module names the benchmark's process may not hold: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'amt_tools_tpu')


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: the
    process's), each compared whole."""

    names = {name.split('.')[0] for name in (sys.modules if modules is None
                                            else modules)}

    return sorted(names & set(FORBIDDEN))


def check_name(name, what):
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f'{what} {name!r} is not a valid name')

    return name


def find(kind, name, suffix, root=HERE):
    """``<root>/<kind>/<name><suffix>``, else the benchmark's own file;
    LookupError for a name neither holds."""

    check_name(name, kind)
    for base in dict.fromkeys((Path(root), HERE)):
        path = base / kind / f'{name}{suffix}'
        if path.is_file():
            return path

    raise LookupError(f'no {kind} file named {name!r}')


def load_json(kind, name, root=HERE):
    return json.loads(find(kind, name, '.json', root).read_text())


def load_code(kind, name, root=HERE):
    """The module ``<kind>/<name>.py``. The benchmark's own modules import
    as ``benchmark.<kind>.<name>`` where the name allows it; others load
    from their path."""

    path = find(kind, name, '.py', root)
    if path.parent.parent == HERE and name.isidentifier():
        return importlib.import_module(f'benchmark.{kind}.{name}')

    module_name = (f'benchmark.{kind}._{re.sub(r"[^A-Za-z0-9_]", "_", name)}'
                   f'_{abs(hash(str(path)))}')
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)

    return sys.modules[module_name]


def load_spec(path=None):
    return json.loads(Path(path or HERE.parent / 'BENCHMARK.json').read_text())


def cell_metrics(spec, cell, trace):
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``trace`` 0, the per-layer ones with 1; an entry with a
    ``workloads`` list only in those cells."""

    kind = 'per_layer' if trace else 'end_to_end'

    return [m for m in spec[kind]
            if 'workloads' not in m or cell in m['workloads']]


class Record:
    """What a run's window leaves for the metric readers: ``window_s`` (all
    the window's time), ``work`` (counts of what completed: ``clips``,
    ``audio_s``, ``steps``), ``attempted`` and ``failed``, ``shape`` (the
    sizes of one batch or step), ``trace`` (a :class:`trace.Trace` of the
    traced stretch, or None), the configuration, its costs module and the
    card's peaks."""

    def __init__(self, ctx, window_s, work, attempted, failed, shape,
                 trace=None):
        self.config = ctx.config
        self.costs = ctx.costs
        self.window_s = window_s
        self.work = work
        self.attempted = attempted
        self.failed = failed
        self.shape = shape
        self.trace = trace
        self.setup_s = None
        self.peaks = peaks.peaks(torch.cuda.get_device_name(ctx.device)
                                 if ctx.device.type == 'cuda' else 'cpu')


class Context:
    """Everything a driver needs for one run, found by name. :meth:`mark`
    ends a named phase of the set-up (``phases``: name -> seconds)."""

    def __init__(self, cell, seed, trace, device, root=HERE, started=None):
        self.last = time.perf_counter() if started is None else started
        self.phases = {}
        self.seed = int(seed)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.workload = load_json('workloads', cell, root)
        self.config = load_json('configs', self.workload['config'], root)
        self.traffic = load_json('traffic', self.workload['traffic'], root)
        self.reference = load_code('reference', self.workload['config'], root)
        self.program = load_code('programs', self.config['family'], root)
        self.generator = load_code('traffic', self.traffic['generator'], root)
        self.costs = load_code('costs', self.config['family'], root)
        self.driver = load_code('drivers', self.workload['driver'], root)

    def mark(self, phase):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self.last
        self.last = now


def device_info(device, chips, memory_peak, busy=None):
    if device.type == 'cuda':
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                'count': chips, 'memory_peak_bytes': int(memory_peak)}
    else:
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': chips,
                'memory_peak_bytes': 0}
    if busy is not None:
        info['busy_s'], info['window_s'] = busy

    return info


def run(spec, cell, seed, seconds, trace, device, started, root=HERE):
    """One run -> the result dict (the JSON line), and the checks as
    ``[(name, value, limit)]`` for the standard error."""

    ctx = Context(cell, seed, trace, device, root, started)
    ctx.mark('imports')
    torch.empty(1, device=ctx.device)
    ctx.mark('device')
    bench = ctx.driver.Bench(ctx)
    bench.setup()
    ctx.mark('warm-up')
    setup_s = time.perf_counter() - started
    print('setup: ' + ', '.join(f'{name} {seconds:.3f} s' for name, seconds
                                in ctx.phases.items()),
          file=sys.stderr, flush=True)

    record = bench.window(seconds)
    record.setup_s = setup_s
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                   if ctx.device.type == 'cuda' else 0)

    checks = bench.check()
    correct = (record.failed == 0 and
               all(value is not None and value <= limit
                   for _, value, limit in checks))

    metrics = {}
    if ctx.device.type == 'cuda':
        for entry in cell_metrics(spec, cell, trace):
            reader = load_code('metrics', entry['name'], root)
            value = reader.read(record)
            if value is not None:
                metrics[entry['name']] = {'value': value,
                                          'unit': entry['unit']}

    busy = None
    if trace and record.trace is not None:
        measured = record.trace.busy()
        if measured is not None and ctx.device.type == 'cuda':
            busy = measured[:2]
    result = {'correct': correct, 'attempted': record.attempted,
              'failed': record.failed, 'metrics': metrics,
              'device': device_info(ctx.device, ctx.workload['chips'],
                                    memory_peak, busy)}
    if trace and record.trace is not None and ctx.device.type == 'cuda':
        result['breakdown'] = {'device_ops': record.trace.device_ops(),
                               'idle_gaps': record.trace.idle_gaps()}
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, value, limit in checks}

    return result, checks
