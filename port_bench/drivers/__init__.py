"""One module a way of offering load, named by a traffic file's ``driver``:
each has ``run(ctx) -> harness.Run``."""
