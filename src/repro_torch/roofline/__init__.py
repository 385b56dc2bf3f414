"""Roofline cost modelling of the port: a fake-tensor trace of a call plus
the H100 SXM hardware model.

``analysis`` holds the hardware constants and the term derivation,
``cost`` the fake-tensor op counter (:func:`trace_cost`, the counterpart
of the JAX package's trip-count-aware HLO walk), ``live`` its wiring onto
a trainer's round (``FederatedTrainer(roofline=True)`` / ``train.py
--roofline``), and ``report`` the ``python -m
repro_torch.roofline.report <run_dir>`` CLI over an emitted
``metrics.jsonl``.  ``launch/dryrun.py`` costs every (architecture,
shape) pair with it.
"""
from repro_torch.roofline.analysis import (COLLECTIVE_OPS, FP32_FLOPS,
                                           HBM_BW, LINK_BW, TF32_FLOPS,
                                           Roofline, bound_s,
                                           model_flops_per_round,
                                           roofline_terms)
from repro_torch.roofline.cost import (Cost, CostCounter, TensorSpec,
                                       trace_cost)
from repro_torch.roofline.live import round_cost_summary, round_roofline_event

__all__ = ["FP32_FLOPS", "TF32_FLOPS", "HBM_BW", "LINK_BW",
           "COLLECTIVE_OPS", "Roofline", "roofline_terms", "bound_s",
           "model_flops_per_round", "Cost", "CostCounter", "TensorSpec",
           "trace_cost", "round_cost_summary",
           "round_roofline_event"]
