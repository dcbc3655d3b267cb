"""Testing aids: the deterministic fault injector of the serve engine."""
