"""``FaultModel``: the deterministic, seeded fault configuration, the
port's copy of ``repro/faults/model.py`` (numpy only, so copied as is).

One frozen dataclass describes everything the injection layer can do to a
federation, threaded through ``ServerConfig.faults`` / ``fl_train
--faults``.  Three orthogonal axes:

availability + stragglers (pre-selection, applied to the raw [N] workload
draw):

  ``availability="diurnal"``   each client is on duty for ``duty_cycle`` of
                               every ``day_rounds``-round day, with a fixed
                               per-client phase (seeded at setup).  An
                               off-duty client that gets selected
                               contributes E=0, i.e. it takes the existing
                               zero-budget crash branch.
  ``straggler="pareto"``       heavy-tailed slowdown draws: every client's
                               workload is divided by an i.i.d. Pareto
                               slowdown >= 1 (tail index ``pareto_alpha``),
                               layered on top of the Gaussian sim in
                               ``core.heterogeneity``.

mid-round dropouts (post-selection):

  ``dropout_prob``             per-(client, round) Bernoulli: a dropped
                               client crashes mid-round (E -> 0, DROPPED
                               outcome, Ira/Fassa halves its task pair).

corrupted uploads (at the engine's upload-transform seam):

  ``corrupt="crash"``          the corrupt client simply crashes: no
                               injection.  This is the *crash twin* of every
                               screened mode below: same seed => same
                               corrupt mask, so a screened run must be
                               bitwise-identical to its crash twin.
  ``corrupt="nan"|"inf"``      the upload is a NaN/Inf-filled delta.
  ``corrupt="explode"``        the delta is scaled by ``explode_factor``.
  ``corrupt="sign_flip"``      the delta's sign is flipped: a *stealthy*
                               Byzantine upload that passes the finite/norm
                               screen by design (robust-aggregator
                               territory).

Determinism contract: every per-round draw comes from
``np.random.default_rng((seed, t, axis))`` (``faults.inject``), so fault
schedules are a pure function of (seed, round index), the same on the CPU
and on the card, and across a checkpoint/resume boundary, and decoupled
from the training and selection streams.  The reference keys the same
schedule as ``fold_in(PRNGKey(seed), t)``, which torch cannot replay: the
two packages draw different schedules from one seed (the server's
``fault_draws=`` seam replays the reference's).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

AVAILABILITY_MODES = ("always", "diurnal")
STRAGGLER_MODES = ("none", "pareto")
CORRUPT_MODES = ("none", "crash", "nan", "inf", "sign_flip", "explode")

#: corrupt modes the server DEMOTES to the zero-budget crash branch: the
#: upload is detectably garbage, so the observed history (Ira/Fassa, value
#: tracker, stats) treats the client exactly as if it had crashed.
#: "sign_flip" is deliberately absent — a flipped delta is finite and
#: norm-plausible, so it reaches the aggregator (where robust aggregation,
#: not screening, is the defense).
SCREENED_CORRUPT = ("crash", "nan", "inf", "explode")

#: corrupt modes that actually mutate the uploaded stack ("crash" injects
#: nothing — the twin run only changes budgets).
INJECTED_CORRUPT = ("nan", "inf", "sign_flip", "explode")


@dataclass(frozen=True)
class FaultModel:
    seed: int = 0
    availability: str = "always"
    day_rounds: int = 24
    duty_cycle: float = 0.5
    straggler: str = "none"
    pareto_alpha: float = 2.0
    dropout_prob: float = 0.0
    corrupt: str = "none"
    corrupt_prob: float = 0.0
    explode_factor: float = 1e8

    def __post_init__(self):
        if self.availability not in AVAILABILITY_MODES:
            raise ValueError(f"availability must be one of "
                             f"{AVAILABILITY_MODES}, got "
                             f"{self.availability!r}")
        if self.straggler not in STRAGGLER_MODES:
            raise ValueError(f"straggler must be one of {STRAGGLER_MODES}, "
                             f"got {self.straggler!r}")
        if self.corrupt not in CORRUPT_MODES:
            raise ValueError(f"corrupt must be one of {CORRUPT_MODES}, got "
                             f"{self.corrupt!r}")
        if self.availability == "diurnal" and self.day_rounds < 1:
            raise ValueError("day_rounds must be >= 1")
        if not 0.0 < self.duty_cycle <= 1.0:
            raise ValueError("duty_cycle must be in (0, 1]")
        if not 0.0 <= self.dropout_prob <= 1.0:
            raise ValueError("dropout_prob must be in [0, 1]")
        if not 0.0 <= self.corrupt_prob <= 1.0:
            raise ValueError("corrupt_prob must be in [0, 1]")
        if self.straggler == "pareto" and self.pareto_alpha <= 0:
            raise ValueError("pareto_alpha must be > 0")

    # ---- static structure of the configured program --------------------
    @property
    def corrupts(self) -> bool:
        """Any corrupt mask is drawn at all."""
        return self.corrupt != "none" and self.corrupt_prob > 0.0

    @property
    def demotes(self) -> bool:
        """Corrupt clients are observed as crashes (screened modes)."""
        return self.corrupts and self.corrupt in SCREENED_CORRUPT

    @property
    def injects(self) -> bool:
        """The uploaded stack is actually mutated (needs the engine's
        corrupt-mask argument threaded through the round fn)."""
        return self.corrupts and self.corrupt in INJECTED_CORRUPT

    @property
    def duty_len(self) -> int:
        """On-duty rounds per day (>= 1 so duty_cycle>0 never blacks out)."""
        return max(1, int(round(self.duty_cycle * self.day_rounds)))

    def phases(self, n_clients: int):
        """Static per-client diurnal phase offsets (int32 [N]), seeded at
        setup; None when the availability trace is 'always'."""
        if self.availability != "diurnal":
            return None
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.day_rounds, n_clients).astype(np.int32)
