"""One reader for each metric: ``metrics/<name>.py`` holds ``read(record)``,
which returns the metric's number, or None where the run's record holds
nothing for it."""
