"""Model functions of the MRF nets."""
