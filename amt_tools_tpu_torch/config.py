"""Experiment configuration and tracking (sacred replacement).

Counterpart of ``amt_tools_tpu/config.py`` (``Experiment``, ``:47``), kept
as this package's own copy: it is pure Python, and the port imports nothing
of the JAX package. The example scripts (``amt_tools_tpu_torch/examples``)
are wired with it as the JAX scripts are, in place of ``sacred``
(``@ex.config`` dicts + ``FileStorageObserver``):

- :class:`Experiment`: named experiment with a default config dict,
  ``key=value`` command-line overrides, and a run directory capturing
  ``config.json``, ``metrics.json``, and the console log.
- ``@ex.config`` registers defaults; ``@ex.automain`` runs the main function
  with the resolved config when the script is executed.
"""

import json
import os
import sys
from datetime import datetime

__all__ = ['Experiment']


def _parse_value(text):
    """Interpret a command-line override value as JSON, falling back to str."""

    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


class _Tee:
    """Mirror a stream into a log file."""

    def __init__(self, stream, log_file):
        self.stream = stream
        self.log_file = log_file

    def write(self, text):
        self.stream.write(text)
        self.log_file.write(text)

    def flush(self):
        self.stream.flush()
        self.log_file.flush()


class Experiment(object):
    """Named experiment with config resolution and file-storage tracking."""

    def __init__(self, name, root_dir=None):
        self.name = name
        self.root_dir = root_dir

        self._config_fns = []
        self._main_fn = None

        self.run_dir = None
        self._metrics = {}

    def config(self, fn):
        """Register a function whose local variables become config defaults."""

        self._config_fns.append(fn)

        return fn

    def resolve_config(self, overrides=None):
        """Config defaults merged with ``key=value`` overrides."""

        config = {}
        for fn in self._config_fns:
            config.update(_capture_locals(fn))

        if overrides:
            for item in overrides:
                if '=' not in item:
                    raise ValueError(f'Override must be key=value: {item!r}')
                key, value = item.split('=', 1)
                if key not in config:
                    raise KeyError(f'Unknown config key: {key!r}')
                config[key] = _parse_value(value)

        return config

    def open_run(self, config):
        """Create a numbered run directory and write the resolved config."""

        if self.root_dir is None:
            from . import tools
            self.root_dir = os.path.join(tools.DEFAULT_EXPERIMENTS_DIR, self.name)

        os.makedirs(self.root_dir, exist_ok=True)

        # Next available numbered run directory (sacred-style)
        existing = [int(d) for d in os.listdir(self.root_dir) if d.isdigit()]
        run_id = max(existing) + 1 if existing else 1

        self.run_dir = os.path.join(self.root_dir, str(run_id))
        os.makedirs(self.run_dir)

        with open(os.path.join(self.run_dir, 'config.json'), 'w') as f:
            json.dump({k: v for k, v in config.items()
                       if _is_json_serializable(v)}, f, indent=2)

        with open(os.path.join(self.run_dir, 'run.json'), 'w') as f:
            json.dump({'experiment': self.name,
                       'start_time': datetime.now().isoformat(),
                       'argv': sys.argv}, f, indent=2)

        return self.run_dir

    def log_scalar(self, name, value, step=0):
        """Track a metric value; flushed to ``metrics.json`` incrementally."""

        entry = self._metrics.setdefault(name, {'steps': [], 'values': []})
        entry['steps'].append(step)
        entry['values'].append(value if _is_json_serializable(value) else str(value))

        if self.run_dir is not None:
            with open(os.path.join(self.run_dir, 'metrics.json'), 'w') as f:
                json.dump(self._metrics, f, indent=2)

    def run(self, overrides=None):
        """Resolve config, open a run directory, and execute the main fn."""

        if self._main_fn is None:
            raise RuntimeError('No main function registered (use @ex.automain).')

        config = self.resolve_config(overrides)
        run_dir = self.open_run(config)

        log_path = os.path.join(run_dir, 'cout.txt')
        with open(log_path, 'w') as log_file:
            stdout = sys.stdout
            sys.stdout = _Tee(stdout, log_file)
            try:
                import inspect
                wanted = inspect.signature(self._main_fn).parameters.keys()
                kwargs = {k: v for k, v in config.items() if k in wanted}
                if 'root_dir' in wanted and 'root_dir' not in kwargs:
                    kwargs['root_dir'] = run_dir
                return self._main_fn(**kwargs)
            finally:
                sys.stdout = stdout

    def automain(self, fn):
        """Register the main function; run it if the defining script is main."""

        self._main_fn = fn

        # Mirror sacred's automain: execute when the caller is __main__
        import inspect
        caller = inspect.stack()[1].frame.f_globals.get('__name__')
        if caller == '__main__':
            self.run(sys.argv[1:])

        return fn


def _capture_locals(fn):
    """Run a zero-arg function and capture its local variable assignments."""

    captured = {}

    def tracer(frame, event, _arg):
        if event == 'return' and frame.f_code is fn.__code__:
            captured.update(frame.f_locals)
        return tracer

    old_tracer = sys.gettrace()
    sys.settrace(tracer)
    try:
        fn()
    finally:
        sys.settrace(old_tracer)

    return captured


def _is_json_serializable(value):
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
