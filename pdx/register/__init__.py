"""pdx.register — device image registration stack (L2).

Device-side replacements for the reference's OpenCV C++ primitives:
phase-correlation translation estimation (cv2.phaseCorrelate), dense
optical flow (Farnebäck / DIS), ECC parametric registration, and the warp
machinery in :mod:`pdx.ops.interp`.
"""

from pdx.register.phasecorr import (
    phase_correlate,
    estimate_shift_phasecorr,
    stabilize_translation_sequence,
    estimate_interframe_shifts,
)
from pdx.register.farneback import (
    farneback_flow,
    farneback_register_sequence,
    farneback_flow_pairs,
    farneback_register_sequence_compose,
    compose_flow_chain,
)
from pdx.register.dis import dis_flow
from pdx.register.tvl1 import tvl1_flow
from pdx.register.ecc import ecc_align, ecc_warp, ecc_register_sequence
from pdx.register.quality import mean_flow_magnitude, registration_improvement

__all__ = [
    "phase_correlate",
    "estimate_shift_phasecorr",
    "stabilize_translation_sequence",
    "estimate_interframe_shifts",
    "farneback_flow",
    "farneback_register_sequence",
    "farneback_flow_pairs",
    "farneback_register_sequence_compose",
    "compose_flow_chain",
    "dis_flow",
    "tvl1_flow",
    "ecc_align",
    "ecc_warp",
    "ecc_register_sequence",
    "mean_flow_magnitude",
    "registration_improvement",
]
