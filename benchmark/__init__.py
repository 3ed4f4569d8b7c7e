"""The benchmark of the PyTorch and CUDA port, ``amt_tools_tpu_torch``.

Run one cell from the repository root::

    python3 benchmark/run.py --workload of2-serve-bf16 --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` at the root names the cells, metrics and bounds. Each
cell's files are found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``, with its plain reference
``reference/<config>.py``), its driver (``drivers/<driver>.py``), its
traffic mix (``traffic/<traffic>.json``, read by the generator it names)
and the adapter that builds the port's objects (``programs/<family>.py``).
A metric is ``metrics/<name>.py``.
"""
