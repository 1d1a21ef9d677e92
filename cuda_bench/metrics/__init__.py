"""One reader a metric, found by the metric's name in ``BENCHMARK.json``
(``metrics/<name>.py``). Each has ``read(run)``, which takes the metric
from a finished run (``bench.Run``; a traced run's records in
``run.record``) and returns a number, or None where it finds nothing to
read, and the harness then leaves the metric out of the result line."""
