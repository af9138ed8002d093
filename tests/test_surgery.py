import numpy as np
import pytest

from autognothi.utils.surgery import MergeError, New, merge_param_dicts


def test_merge_semantics_fanout_keep_remove_new():
    src_1 = {
        "alpha.default.0": 0,
        "alpha.default.1": 0,
        "alpha.0": 0,
        "alpha.1": 0,
        "beta.2": 0,
        "gamma.3": 0,
    }
    src_2 = {"iota.0": 1, "kappa.1": 1}
    dest = {
        "alpha.default.0": 9,
        "alpha.default.1": 9,
        "alpha.0": 9,
        "alpha.1": 9,
        "epsilon.0": 9,
        "epsilon.1": 9,
        "zeta.0": 9,
        "zeta.1": 9,
        "gamma.3": 2,
        "iota.0": 9,
        "theta.4": 2,
    }
    rules_1 = {
        "alpha.default.{_}": ...,
        "alpha.{_}": [..., "epsilon.{_}", "zeta.{_}"],
        "beta.{_}": None,
        "gamma.{_}": None,
        New(): "gamma.{_}",
        New(): "theta.{_}",
    }
    rules_2 = {"iota.{_}": ..., "kappa.{_}": None}
    out = merge_param_dicts(
        (rules_1, src_1),
        (rules_2, src_2),
        into=dest,
        duplicate_action=lambda x: x + 5,
    )
    assert out == {
        "alpha.default.0": 0,
        "alpha.default.1": 0,
        "alpha.0": 0,
        "alpha.1": 0,
        "epsilon.0": 5,
        "epsilon.1": 5,
        "zeta.0": 5,
        "zeta.1": 5,
        "gamma.3": 2,
        "iota.0": 1,
        "theta.4": 2,
    }


def test_merge_fails_closed_on_unclaimed_dest():
    rules = {"alpha.{_}": "beta.{_}"}
    src = {"alpha.0": 0, "alpha.1": 0}
    dest = {"beta.0": 1, "beta.1": 1, "gamma.0": 1}
    with pytest.raises(MergeError):
        merge_param_dicts((rules, src), into=dest)


def test_merge_fails_closed_on_unmatched_src():
    rules = {"alpha.{_}": ...}
    src = {"alpha.0": 0, "stray.0": 1}
    dest = {"alpha.0": 9}
    with pytest.raises(MergeError):
        merge_param_dicts((rules, src), into=dest)


def test_merge_arrays_copied_on_fanout():
    w = np.ones((2, 2), dtype=np.float32)
    rules = {"a.w": [..., "b.w"]}
    out = merge_param_dicts((rules, {"a.w": w}), into={"a.w": w * 0, "b.w": w * 0})
    assert out["a.w"] is w
    assert out["b.w"] is not w
    np.testing.assert_array_equal(out["b.w"], w)
