"""Serving: config, page pool, scheduler and the slot engine."""
