"""The benchmark of ``trialign_torch`` on NVIDIA GPUs.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output.  The harness finds each cell's
configuration, traffic mix and metric readers by name under this directory,
and checks every run against the plain reference in ``reference/``.
"""
