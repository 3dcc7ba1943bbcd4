"""Analysis of the port's steps: the step recorder (``torch_trace``), the
program-contract linter (``contracts``, ``lint``) and the per-device
statistics of a recorded step (``program_stats``), the replay cost model
(``costs``, ``replay``), analytic model flops and the static source
checks. Counterpart of ``repro.analysis``."""
