"""The benchmark of the PyTorch/CUDA port (``hunyuan3d2_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run, with the
  ``system`` that drives it (``systems/<system>.py``);
* ``reference/<config>.py``: its plain reference and the comparison that
  decides ``correct``;
* ``traffic/<traffic>.json``: the traffic mix: the parameters of the
  generator it names (``generators/<generator>.py``) and the loop that
  sends its requests (``loops/<loop>.py``);
* ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
