"""Deterministic fault injection and server-side defenses, the port's
counterpart of ``repro/faults``.

``faults.model`` holds the configuration surface (a copy of the
reference's), ``faults.inject`` the seeded host draws and the upload
corruption, ``faults.screen`` the finite-upload screen (with a form that
reads nothing on the host, for the device drivers) and the reliability
quarantine.  The port's fault stream is its own: a pure function of
(seed, round, axis) drawn from numpy on the host.
"""
from repro_torch.faults.inject import (apply_availability_stragglers,
                                       apply_availability_stragglers_device,
                                       availability_mask, block_fault_draws,
                                       corrupt_mask, dropout_mask,
                                       inject_upload_faults,
                                       round_fault_draws, round_fault_rng,
                                       straggler_slowdowns)
from repro_torch.faults.model import (AVAILABILITY_MODES, CORRUPT_MODES,
                                      INJECTED_CORRUPT, SCREENED_CORRUPT,
                                      STRAGGLER_MODES, FaultModel)
from repro_torch.faults.screen import (eligibility, quarantine_update,
                                       screen_uploads, screen_uploads_device)

__all__ = [
    "FaultModel", "AVAILABILITY_MODES", "STRAGGLER_MODES", "CORRUPT_MODES",
    "SCREENED_CORRUPT", "INJECTED_CORRUPT",
    "round_fault_rng", "round_fault_draws", "block_fault_draws",
    "straggler_slowdowns", "availability_mask",
    "apply_availability_stragglers", "apply_availability_stragglers_device",
    "dropout_mask", "corrupt_mask", "inject_upload_faults",
    "screen_uploads", "screen_uploads_device", "quarantine_update",
    "eligibility",
]
