"""dpowbench: the end-to-end benchmark of tpu_dpow_torch.

``python -m dpowbench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once: the port's broker, hub and
worker as three processes, traffic from this package's frozen generator, and
every served answer judged by ``reference.py``. See README.md.
"""
