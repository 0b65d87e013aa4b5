"""The grouped config surface (ROADMAP A15): ``ServerConfig(compute=,
comm=, robustness=)`` against the reference's.

The reference's own five tests of the surface
(``tests/test_local_step.py``), ported; then one table of group and flat
combinations built by both packages, with the same flat fields, the same
warnings and the same errors.
"""
import dataclasses
import warnings

import pytest

from repro.core.server import CommConfig as RComm
from repro.core.server import ComputeConfig as RCompute
from repro.core.server import RobustnessConfig as RRobustness
from repro.core.server import ServerConfig as RConfig
from repro.faults import FaultModel as RFaultModel
from repro_torch import (CommConfig, ComputeConfig, RobustnessConfig,
                         ServerConfig)
from repro_torch.faults import FaultModel
from torch_cases import one_torch_thread  # noqa: F401

GROUPS = ("compute", "comm", "robustness")


def test_grouped_config_materializes_flat_fields():
    cfg = ServerConfig(compute=ComputeConfig(driver="scan", mesh_shards=2),
                       comm=CommConfig(upload_compress="topk_q8"),
                       robustness=RobustnessConfig(upload_screen="on"))
    assert cfg.driver == "scan" and cfg.mesh_shards == 2
    assert cfg.upload_compress == "topk_q8" and cfg.upload_screen == "on"
    # groups are always re-materialized: no two views to keep in sync
    assert cfg.compute.driver == cfg.driver
    assert cfg.comm.topk_frac == cfg.topk_frac


def test_flat_kwargs_deprecate_but_work():
    with pytest.warns(DeprecationWarning, match="driver"):
        cfg = ServerConfig(driver="scan", block_size=4)
    assert cfg.compute.driver == "scan" and cfg.compute.block_size == 4


def test_conflicting_flat_and_group_values_raise():
    # both spellings explicitly non-default AND different: an error
    with pytest.raises(ValueError, match="block_size"):
        ServerConfig(block_size=8, compute=ComputeConfig(block_size=4))


def test_flat_default_yields_to_group_and_vice_versa():
    # group explicit, flat at default -> group wins
    assert ServerConfig(compute=ComputeConfig(driver="scan")).driver == \
        "scan"
    # flat explicit, group field left at ITS default -> flat wins, and the
    # mixed form does not warn (replace() re-passes every flat field)
    cfg = ServerConfig(driver="scan", compute=ComputeConfig(block_size=4))
    assert cfg.driver == "scan" and cfg.block_size == 4


def test_dataclasses_replace_keeps_flat_spelling_working():
    cfg = ServerConfig(compute=ComputeConfig(driver="scan"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # replace() must not deprecate
        bumped = dataclasses.replace(cfg, backend="pallas")
    assert bumped.backend == "pallas" and bumped.compute.backend == "pallas"
    assert bumped.driver == "scan"       # group value survives the replace


def test_groups_are_exported_with_the_reference_fields():
    import repro_torch
    assert repro_torch.__all__ == sorted(repro_torch.__all__)
    for ours, ref in ((ComputeConfig, RCompute), (CommConfig, RComm),
                      (RobustnessConfig, RRobustness)):
        assert getattr(repro_torch, ours.__name__) is ours
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(ref)]


# ---------------------------------------------------------------------------
# the parity table: the same combinations through both packages
# ---------------------------------------------------------------------------

#: a fault model, built by each package from these arguments
FAULTS = dict(seed=1, corrupt="nan", corrupt_prob=0.3)

#: case -> (groups: name -> group kwargs, flat kwargs); "FAULTS" stands
#: for each package's own FaultModel(**FAULTS)
CASES = {
    "defaults": ({}, {}),
    "plain-flat": ({}, dict(algo="fassa", n_selected=5)),
    "group-only": (dict(compute=dict(driver="scan", mesh_shards=2)), {}),
    "flat-deprecated": ({}, dict(driver="scan", block_size=4)),
    "flat-each-group": ({}, dict(driver="scan", upload_compress="topk_q8",
                                 screen_norm_bound=10.0)),
    "conflict": (dict(compute=dict(block_size=4)), dict(block_size=8)),
    "conflict-comm": (dict(comm=dict(topk_frac=0.2)), dict(topk_frac=0.3)),
    "conflict-capacity": (dict(compute=dict(cohort_capacity="auto")),
                          dict(cohort_capacity=4)),
    "same-in-both": (dict(compute=dict(driver="scan")),
                     dict(driver="scan")),
    "flat-fills-group-default": (dict(compute=dict(block_size=4)),
                                 dict(driver="scan")),
    "comm-and-flat": (dict(comm=dict(upload_compress="topk_q8")),
                      dict(topk_frac=0.2)),
    "robustness-and-flat": (dict(robustness=dict(upload_screen="on")),
                            dict(quarantine_threshold=0.5)),
    "flat-robustness": ({}, dict(upload_screen="off", quarantine_rounds=4)),
    "group-faults": (dict(robustness=dict(faults="FAULTS")), {}),
    "flat-faults-group-default": (dict(robustness=dict()),
                                  dict(faults="FAULTS")),
    "flat-faults": ({}, dict(faults="FAULTS")),
    "all-groups": (dict(compute=dict(rng_impl="device", prefetch="off",
                                     fused_generic=False),
                        comm=dict(topk_frac=0.5),
                        robustness=dict(quarantine_min_tries=1)),
                   dict(algo="fedprox")),
    "group-and-other-group-flat": (dict(compute=dict(driver="scan")),
                                   dict(upload_compress="topk_q8")),
}


def _build(pkg, case):
    """ServerConfig of ``pkg`` ("ref" or "port") for ``case``, with the
    warnings it raised and the error it raised (as (type, message))."""
    groups, flat = CASES[case]
    config, classes, fm = (
        (RConfig, dict(compute=RCompute, comm=RComm,
                       robustness=RRobustness), RFaultModel)
        if pkg == "ref" else
        (ServerConfig, dict(compute=ComputeConfig, comm=CommConfig,
                            robustness=RobustnessConfig), FaultModel))

    def args(kw):
        return {k: fm(**FAULTS) if v == "FAULTS" else v
                for k, v in kw.items()}

    kw = dict(args(flat), **{g: classes[g](**args(v))
                             for g, v in groups.items()})
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            cfg, error = config(**kw), None
        except Exception as e:             # noqa: BLE001 - compared below
            cfg, error = None, (type(e), str(e))
    return cfg, [(w.category, str(w.message)) for w in seen], error


def _fields(cfg):
    """The reference's flat fields of a config; a fault model as its
    fields."""
    out = {}
    for f in dataclasses.fields(RConfig):
        if f.name in GROUPS:
            continue
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if f.name == "faults" and \
            v is not None else v
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_config_parity(case):
    ref, ref_warnings, ref_error = _build("ref", case)
    ours, our_warnings, our_error = _build("port", case)
    assert our_error == ref_error
    assert our_warnings == ref_warnings
    if ref is None:
        return
    assert _fields(ours) == _fields(ref)
    for g in GROUPS:                       # rebuilt from the flat fields
        group = getattr(ours, g)
        for f in dataclasses.fields(group):
            assert getattr(group, f.name) is getattr(ours, f.name)
