"""Static-analysis tooling for the port's own invariants (PyTorch port of
``repro/analysis``).

General-purpose linters cannot see this codebase's contracts: host rng
streams keyed by constants from one registry, kernel wrappers that
dispatch on the device of their tensors beside a same-signature oracle,
registry classes declaring their full capability surface, round bodies
free of host reads of device values.  :mod:`repro_torch.analysis.fedlint`
checks exactly those, from the CLI (``python -m
repro_torch.analysis.fedlint src/repro_torch``).
"""
