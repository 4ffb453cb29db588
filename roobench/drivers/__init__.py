"""One module a driver, named by a traffic file's ``driver`` key; each has
``run(ctx) -> harness.Outcome``."""
