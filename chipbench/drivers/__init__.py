"""One driver for each kind of traffic, found by the ``kind`` that a
traffic file names: ``run(ctx)`` drives the program and returns the
run's record."""
