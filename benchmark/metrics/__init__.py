"""One module a metric: ``read(record, metric, context)`` -> the number,
or None where the run holds nothing to read (the metric is then left out of
the line).  A metric ``<base>.<suffix>`` is read by ``<base>.py``; the
suffix names the end-to-end metric it moves (BENCHMARK.json ``moves``)."""
