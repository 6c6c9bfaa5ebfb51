"""The benchmark of scalablevectorsearch_tpu_torch: one served cell per run.

``python annbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, one traffic
mix, one index kind or one metric sits in a file of its own, found by
name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``indexes/<kind>.py`` and ``metrics/<metric>.py``.  The yardstick
(``data.py``, ``reference.py``, ``check.py``, ``roofline.py``,
``trace.py``) imports nothing of the program.
"""
