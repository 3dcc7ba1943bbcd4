"""Training utilities (counterpart of ``repro.train``): the optimizers."""
