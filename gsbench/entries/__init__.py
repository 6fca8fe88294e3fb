"""One driver per entry point of the program; a traffic mix names its
driver by ``entry``. Each has ``measure(run) -> harness.Outcome``."""
