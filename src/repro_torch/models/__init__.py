"""Model functions: the MRF nets and the dense LM family."""
