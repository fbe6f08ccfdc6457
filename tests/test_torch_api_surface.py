"""The port's public API surface against the JAX package's snapshot.

``repro_torch.api.__all__``, every spec's fields (in order: a positional
spec binds the same fields in both packages) and the config views are held
to ``tests/test_api_surface.py``'s golden data, with the port's listed
additions and without what is not ported yet (nothing, since the serving
half landed: ``Serve`` and ``serve_experiment`` are held to the snapshot).
"""
import dataclasses

import test_api_surface as golden

import repro_torch.api as api
from repro_torch.cohort.driver import CohortConfig
from repro_torch.core.mocha import MochaConfig

#: names the port adds to ``__all__``
ADDED_ALL = {"INNER_DRIVERS"}
#: names of the JAX package's surface the port does not have yet
NOT_YET = set()
#: fields the port appends to a spec or config view
ADDED_FIELDS = {"Exec": ("device",), MochaConfig: ("device",)}
#: provenance keys the port adds after ``backend``
ADDED_PROVENANCE = ("device", "device_name")


def test_api_all_snapshot():
    assert set(api.__all__) == (golden.EXPECTED_ALL - NOT_YET) | ADDED_ALL
    for name in api.__all__:
        assert hasattr(api, name), f"__all__ exports missing name {name!r}"
    for name in NOT_YET:
        assert not hasattr(api, name)


def test_spec_field_snapshot():
    assert "Serve" in golden.EXPECTED_FIELDS
    for name, fields in golden.EXPECTED_FIELDS.items():
        if name in NOT_YET:
            continue
        cls = getattr(api, name)
        got = tuple(f.name for f in dataclasses.fields(cls))
        assert got == fields + ADDED_FIELDS.get(name, ()), (
            f"{name} fields drifted: {got}")


def test_config_view_field_snapshot():
    ours = {MochaConfig.__name__: MochaConfig,
            CohortConfig.__name__: CohortConfig}
    for cls, fields in golden.EXPECTED_CONFIG_FIELDS.items():
        mine = ours[cls.__name__]
        got = tuple(f.name for f in dataclasses.fields(mine))
        assert got == fields + ADDED_FIELDS.get(mine, ()), (
            f"{cls.__name__} fields drifted: {got}")


def test_positional_exec_binds_the_jax_fields():
    import repro.api as japi
    args = ("local", "loop", 64, None, None, None, 8)
    mine, theirs = api.Exec(*args), japi.Exec(*args)
    for f in dataclasses.fields(theirs):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.cohort == 8 and mine.device == "cuda"


def test_route_paths_and_provenance_keys_snapshot():
    import repro.api as japi
    assert api.PATHS == japi.PATHS == ("single", "sweep", "grid", "cohort")
    assert api.PROBLEM_KINDS == japi.PROBLEM_KINDS
    assert api.INNER_DRIVERS == ("scan", "loop", "vmap")
    assert api.METRICS == japi.METRICS == ("error", "loss")
    i = japi.PROVENANCE_KEYS.index("backend") + 1
    assert api.PROVENANCE_KEYS == (japi.PROVENANCE_KEYS[:i] + ADDED_PROVENANCE
                                   + japi.PROVENANCE_KEYS[i:])


def test_base_provenance_has_the_provenance_keys():
    prov = api.base_provenance(device="cpu")
    assert tuple(prov) == api.PROVENANCE_KEYS
    assert (prov["backend"], prov["device"], prov["device_name"]) == (
        "cpu", "cpu", "cpu")
    assert prov["path"] is None and prov["config_hash"] is None
    assert isinstance(prov["gram_max_d"], int)


def test_eval_report_is_the_core_one():
    from repro_torch.core.evaluate import METRICS, EvalReport
    assert api.EvalReport is EvalReport and api.METRICS is METRICS
