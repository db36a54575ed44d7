"""MRF map-reconstruction serving: request queue, wave executor, engine."""
