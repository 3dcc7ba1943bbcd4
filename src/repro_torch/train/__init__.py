"""Training (counterpart of ``repro.train``): the optimizers and the LM
training loop."""
