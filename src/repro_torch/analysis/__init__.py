"""Analysis of the port's steps: the step recorder (``torch_trace``), the
replay cost model (``costs``, ``replay``), analytic model flops and the
static source checks. Counterpart of ``repro.analysis``."""
