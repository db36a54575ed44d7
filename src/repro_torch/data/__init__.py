"""MRF fingerprint simulation, sample streams and the phantom slice."""
