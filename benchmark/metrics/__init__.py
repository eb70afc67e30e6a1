"""One reader a metric: ``<metric>.py`` holds ``read(run)``, which takes a
run's record (the dict ``harness.run_cell`` builds: the window's reads,
clock, stage seconds and counters, the set-up's spans and, in a traced
run, the reduced trace and the stream launches) and returns the number,
or None when the run has nothing to read for it (the harness then leaves
the metric out)."""
