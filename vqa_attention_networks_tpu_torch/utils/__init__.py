"""Run utilities of the port: checkpoints, the metric writer, the timer and
the reference ``.pth`` importer."""
