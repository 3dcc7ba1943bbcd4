"""LM data (counterpart of ``repro.data``): the synthetic token pipeline."""
