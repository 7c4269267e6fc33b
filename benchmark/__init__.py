"""The benchmark of ``mipheivit_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (which
names its driver in ``drivers/``), its output limits in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. The yardstick lives here too: the inputs and
weights made from the seed (``inputs.py``, ``weights.py``), the operations
and bytes of each op (``work/``), the peaks (``peaks.py``), the plain
reference (``reference/``: each generator composed from the pieces named
by its configuration's ``encoder.kind`` and ``decoder.kind``, in
``reference/encoders/`` and ``reference/decoders/``) and the comparisons
that decide ``correct`` (``compare.py``).
"""
